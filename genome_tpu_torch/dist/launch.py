"""Multi-process worker for partitioned assembly (port of
genome_tpu/dist/launch.py).

One process per rank, one rank per card; run one on every rank:

    python -m genome_tpu_torch.dist.launch --coordinator host0:12355 \
        --num-processes 2 --process-id 0 reads.fastq -o contigs.fasta

Every process reads the same input files and takes its own contiguous
record shard (the process_id-th of num_processes); on the sharded path
each writes its slice of the contigs and rank 0 merges them into the
output (a shared file system). `--coordinator` is rank 0's host:port
(tcp) or a URL such as file:///shared/rendezvous. `--device cpu` runs a
gloo group on the CPU (a localhost job for tests); the default `cuda`
runs NCCL on cuda:{LOCAL_RANK}, or cuda:{process_id % cards}.

`--checkpoint-dir ck/` saves each rank's count, build and simplify
artifacts; `--resume` skips a phase when every rank's artifact matches
(params, shard count, world size, this rank's input digest).
GENOME_TPU_CRASH_AFTER="<phase>[:<rank>]" injects a crash after a phase.

`--bench --bench-out scaling.jsonl`: every process assembles a second
time (the first run is the warm-up) and appends one JSON line: reads/s
of its shard and of the whole job, wall seconds by phase, the exchange
ledger. Efficiency at N processes is reads_per_sec_total(N) /
(N * reads_per_sec_total(1)).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.checkpoint import (PhaseCheckpointer,
                                                  input_digest)
from genome_tpu_torch.dist.mesh import all_max, group_device
from genome_tpu_torch.dist.multihost import assemble_multihost, initialize
from genome_tpu_torch.io.native import count_fastx_records, parse_fastx_codes
from genome_tpu_torch.params import AssemblyParams


def _load_local_shard(paths, pid: int, num_processes: int) -> np.ndarray:
    """Decode only this process's contiguous record shard (uint8 codes).

    The split of dist.assemble.shard_reads (per = ceil(total / P); shard
    i is records [i * per, (i + 1) * per)), but each process range-reads
    its slice through the native parser's record index instead of
    parsing the whole input: ingest stays about flat in P. Rows are
    padded with code 4 to the widest file; an empty shard is a (0, 1)
    matrix."""
    counts = [count_fastx_records(p) for p in paths]
    total = sum(counts)
    per = (total + num_processes - 1) // num_processes
    lo, hi = pid * per, min(total, (pid + 1) * per)
    mats = []
    base = 0
    for p, c in zip(paths, counts):
        a, b = max(lo - base, 0), min(hi - base, c)
        if b > a:
            mats.append(parse_fastx_codes(p, record_range=(a, b)))
        base += c
    if not mats:
        return np.zeros((0, 1), dtype=np.uint8)
    L = max(m.shape[1] for m in mats)
    out = np.full((sum(m.shape[0] for m in mats), L), 4, dtype=np.uint8)
    at = 0
    for m in mats:
        out[at : at + m.shape[0], : m.shape[1]] = m
        at += m.shape[0]
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="genome_tpu_torch.dist.launch")
    p.add_argument("reads", nargs="+")
    p.add_argument("-o", "--output", default="contigs.fasta")
    p.add_argument("--coordinator", default="localhost:12355",
                   help="rank 0's host:port, or a file:// URL")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--k", type=int, default=21)
    p.add_argument("--min-coverage", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default: NCCL, one card a process) or cpu "
                        "(gloo)")
    p.add_argument("--bench", action="store_true",
                   help="time a second (warm) assembly and emit a reads/s "
                        "JSON line per process")
    p.add_argument("--bench-out", default="",
                   help="append bench JSON lines here (default stderr)")
    p.add_argument("--forbid-replicated", action="store_true",
                   help="fail instead of falling back to the replicated "
                        "simplify path")
    p.add_argument("--checkpoint-dir", default="",
                   help="save per-process phase artifacts (.npz per shard) "
                        "here after count/build/simplify")
    p.add_argument("--resume", action="store_true",
                   help="skip phases whose per-process artifacts all match "
                        "(params hash, shard count, world size, input "
                        "digest); requires --checkpoint-dir")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # no card for --device cuda: raises here, before joining any group
    dev = initialize(args.coordinator, args.num_processes, args.process_id,
                     args.device)
    try:
        t_ing = time.perf_counter()
        local = _load_local_shard(args.reads, args.process_id,
                                  args.num_processes)
        ingest_s = time.perf_counter() - t_ing
        params = AssemblyParams(k=args.k, min_coverage=args.min_coverage)
        ckpt = None
        if args.checkpoint_dir:
            # pin the world size (owner hashing is per rank) and this
            # rank's input digest: a resume under another topology or on
            # modified input is rejected
            ckpt = PhaseCheckpointer(args.checkpoint_dir, params,
                                     shard=args.process_id,
                                     num_shards=args.num_processes,
                                     load_enabled=args.resume,
                                     n_devices=dist.get_world_size(),
                                     input_digest=input_digest(local))
        # the output is written inside assemble_multihost: on the sharded
        # path every rank writes its contig slice, rank 0 merges them
        n_contigs = assemble_multihost(
            local, params, forbid_replicated=args.forbid_replicated,
            ckpt=ckpt, out_path=args.output, device=dev)

        if args.bench:
            # the second, warm run is the measured one; every rank enters
            # it together
            phases: dict = {}
            all_max(0)  # barrier
            t0 = time.perf_counter()
            n_contigs = assemble_multihost(
                local, params, forbid_replicated=args.forbid_replicated,
                phase_times=phases, out_path=args.output, device=dev)
            wall = time.perf_counter() - t0
            total = torch.tensor([len(local)], dtype=torch.int64,
                                 device=group_device())
            dist.all_reduce(total)
            n_total = int(total.item())
            ledger = phases.pop("exchange_ledger", None)
            rec = {
                "metric": "reads_per_sec",
                "process_id": args.process_id,
                "num_processes": args.num_processes,
                "local_reads": len(local),
                "wall_s": round(wall, 3),
                "ingest_s": round(ingest_s, 3),
                "reads_per_sec_local": round(len(local) / wall, 1),
                "reads_per_sec_total": round(n_total / wall, 1),
                "phases_s": {k2: round(v, 3) for k2, v in phases.items()},
                "n_contigs": n_contigs,
                "exchange_ledger": ledger,
            }
            line = json.dumps(rec)
            if args.bench_out:
                with open(args.bench_out, "a") as f:
                    f.write(line + "\n")
            else:
                print(line, file=sys.stderr)

        if args.process_id == 0:
            print(f"[genome_tpu_torch.dist] wrote {n_contigs} contigs to "
                  f"{args.output}", file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
