"""Test read-set generator CLI (port of genome_tpu/io/fixtures.py; same
flags, same bytes written for the same flags).

Writes a FASTQ read set plus the truth genome as FASTA, deterministic
per seed, with planted rRNA-operon/IS-style repeats and diploid
heterozygosity as options.

    python -m genome_tpu_torch.io.fixtures -o reads.fastq \
        --genome-len 4600000 --coverage 24 --error-rate 0.002 \
        [--repeats] [--het 0.001] [--circular] [--seed 7] \
        [--truth genome.fasta]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    from genome_tpu_torch.io.simulate import (plant_repeats, random_genome,
                                              simulate_reads,
                                              simulate_reads_diploid)

    ap = argparse.ArgumentParser(prog="genome_tpu_torch.io.fixtures")
    ap.add_argument("-o", "--output", required=True,
                    help="FASTQ output path")
    ap.add_argument("--genome-len", type=int, default=100_000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--coverage", type=float, default=24.0)
    ap.add_argument("--error-rate", type=float, default=0.002)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gc", type=float, default=0.5)
    ap.add_argument("--circular", action="store_true")
    ap.add_argument("--repeats", action="store_true",
                    help="plant ~1%% near-identical long repeats "
                         "(rRNA-operon/IS analog)")
    ap.add_argument("--het", type=float, default=0.0,
                    help="diploid het-SNP rate (> 0: reads drawn "
                         "half-and-half from two haplotypes)")
    ap.add_argument("--truth", default="",
                    help="also write the truth genome as FASTA here")
    args = ap.parse_args(argv)

    g = random_genome(args.genome_len, seed=args.seed, gc=args.gc)
    if args.repeats:
        g = plant_repeats(g, seed=args.seed + 1)
    if args.het > 0:
        if args.circular:
            ap.error("--het does not support --circular")
        reads = simulate_reads_diploid(
            g, het_rate=args.het, read_len=args.read_len,
            coverage=args.coverage, error_rate=args.error_rate,
            seed=args.seed + 2)
    else:
        reads = simulate_reads(
            g, read_len=args.read_len, coverage=args.coverage,
            error_rate=args.error_rate, circular=args.circular,
            seed=args.seed + 2)

    with open(args.output, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    if args.truth:
        with open(args.truth, "w") as f:
            f.write(">truth\n")
            for at in range(0, len(g), 80):
                f.write(g[at : at + 80] + "\n")
    print(f"[fixtures] wrote {len(reads)} reads "
          f"({args.genome_len} bp genome, cov {args.coverage}, "
          f"err {args.error_rate}, repeats={args.repeats}, "
          f"het={args.het}) -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
