"""Command-line entry point (port of genome_tpu/assemble/cli.py).

    python -m genome_tpu_torch.assemble.cli reads.fastq [more.fastq ...] \
        -o contigs.fasta --k 21 --min-coverage 2 [--device cuda|cpu] \
        [--checkpoint-dir ck/ --resume] [--metrics run.jsonl] [--profile dir/]

Same flags as the JAX CLI, except that --io offers only `python` and
--counter only `sort` (the native parser and the other counters are not
ported yet), and there is no golden backend (the JAX package keeps it).
"""

from __future__ import annotations

import argparse
import sys
import time

from genome_tpu_torch.assemble.checkpoint import (PhaseCheckpointer,
                                                  device_count, input_digest)
from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.io import read_fastx, write_fasta
from genome_tpu_torch.params import AssemblyParams


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="genome_tpu_torch",
        description="de novo genome assembler on PyTorch/CUDA (the port of "
                    "genome_tpu)")
    p.add_argument("reads", nargs="+", help="FASTA/FASTQ input file(s), .gz ok")
    p.add_argument("-o", "--output", default="contigs.fasta",
                   help="output FASTA path (default: %(default)s; .gz ok)")
    p.add_argument("--fai", action="store_true",
                   help="also write a samtools-style .fai index")
    p.add_argument("--k", type=int, default=21, help="k-mer length (odd, <=31)")
    p.add_argument("--min-coverage", type=int, default=2,
                   help="k-mer count threshold (default: %(default)s)")
    p.add_argument("--tip-len", type=int, default=None,
                   help="max tip chain length in nodes (default: 2k)")
    p.add_argument("--bubble-len", type=int, default=None,
                   help="max bubble side length in nodes (default: 2k+1)")
    p.add_argument("--min-contig-len", type=int, default=0,
                   help="drop contigs shorter than this many bases")
    p.add_argument("--max-rounds", type=int, default=64,
                   help="simplification round bound")
    p.add_argument("--capacity", type=int, default=None,
                   help="k-mer table capacity (default: auto with retry)")
    p.add_argument("--max-device-kmers", type=int, default=None,
                   help="stream counting in chunks of this many windows "
                        "(bounds device memory; default: one shot)")
    p.add_argument("--counter", choices=["sort"], default="sort",
                   help="counting kernel: global sort + run-length encoding")
    p.add_argument("--io", choices=["python"], default="python",
                   help="input parser (pure Python)")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default=None,
                   help="directory for phase-boundary checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="reuse matching phase checkpoints (requires "
                        "--checkpoint-dir)")
    p.add_argument("--metrics", default=None, help="JSONL metrics output path")
    p.add_argument("--profile", default=None,
                   help="dump a torch.profiler Chrome trace to this directory")
    p.add_argument("--quiet", action="store_true", help="suppress progress log")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        params = AssemblyParams(
            k=args.k, min_coverage=args.min_coverage, tip_len=args.tip_len,
            bubble_len=args.bubble_len, max_rounds=args.max_rounds,
            min_contig_len=args.min_contig_len)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.resume and not args.checkpoint_dir:
        print("error: --resume requires --checkpoint-dir", file=sys.stderr)
        return 2

    metrics = Metrics(path=args.metrics, quiet=args.quiet)
    t0 = time.perf_counter()
    try:
        reads = []
        for path in args.reads:
            reads.extend(read_fastx(path))
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    metrics.log("phase_end", phase="read_input",
                wall_s=round(time.perf_counter() - t0, 4),
                n_reads=len(reads), total_bp=sum(map(len, reads)))

    from genome_tpu_torch.assemble.pipeline import run_pipeline
    # without --resume, checkpoints are written but never read back; the
    # manifest pins the device count and an input digest so a resume
    # against other reads or another topology is rejected
    ndev = digest = None
    if args.checkpoint_dir:
        ndev = device_count(args.device)
        digest = input_digest(reads)
    ckpt = PhaseCheckpointer(args.checkpoint_dir, params,
                             load_enabled=args.resume,
                             n_devices=ndev, input_digest=digest)
    result = run_pipeline(reads, params, capacity=args.capacity,
                          metrics=metrics, ckpt=ckpt,
                          profile_dir=args.profile,
                          max_device_kmers=args.max_device_kmers,
                          counter=args.counter, device=args.device)
    contigs = result["contigs"]

    write_fasta(args.output, contigs, index=args.fai)
    from genome_tpu_torch.assemble.stats import assembly_stats
    metrics.log("done", output=args.output,
                params_hash=params.params_hash(), **assembly_stats(contigs))
    metrics.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
