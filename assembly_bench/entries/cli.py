"""Entry `cli`: `python -m genome_tpu_torch.assemble.cli reads.fastq -o
contigs.fasta`, called in process as `cli.main([...])` on a FASTQ file
written in set-up by the benchmark's own writer, with `--metrics` and
`--quiet` and otherwise the defaults users get. A job ends when `main`
returns; its FASTA is read back after the window by the benchmark's own
reader."""

from __future__ import annotations

import json
import os

from assembly_bench.fastx import read_fasta, write_fastq


def prepare(codes, cfg: dict, workdir: str, device: str, name: str) -> dict:
    fq = os.path.join(workdir, f"{name}.fastq")
    write_fastq(fq, codes)
    out = os.path.join(workdir, "out")
    os.makedirs(out, exist_ok=True)
    args = [fq, "--k", str(cfg["k"]),
            "--min-coverage", str(cfg["min_coverage"]),
            "--max-rounds", str(cfg["max_rounds"]), "--quiet"]
    for flag, key in (("--tip-len", "tip_len"),
                      ("--bubble-len", "bubble_len")):
        if cfg[key] is not None:
            args += [flag, str(cfg[key])]
    if device != "cuda":
        args += ["--device", device]
    return dict(fastq=fq, out=out, args=args)


def _paths(state: dict, job: int) -> tuple[str, str]:
    base = os.path.join(state["out"], f"job{job:06d}")
    return base + ".fasta", base + ".jsonl"


def run(state: dict, job: int):
    from genome_tpu_torch.assemble.cli import main
    fasta, jsonl = _paths(state, job)
    rc = main(state["args"] + ["-o", fasta, "--metrics", jsonl])
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    return job


def collect(state: dict, job: int) -> tuple[list[str] | None, list[dict]]:
    """(the contigs of the job's FASTA in file order, or None where its
    ids are not contig_0, contig_1, ...; the job's metrics events)."""
    fasta, jsonl = _paths(state, job)
    recs = read_fasta(fasta)
    with open(jsonl) as f:
        events = [json.loads(line) for line in f if line.strip()]
    os.unlink(fasta)
    os.unlink(jsonl)
    if [n for n, _ in recs] != [f"contig_{i}" for i in range(len(recs))]:
        return None, events
    return [s for _, s in recs], events


def cleanup(state: dict) -> None:
    os.unlink(state["fastq"])
