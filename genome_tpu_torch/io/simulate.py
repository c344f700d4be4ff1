"""Deterministic read simulator (SURVEY.md §4 fixtures; reference analog:
the E. coli simulated test read sets, BASELINE.json:7,10).

Seeded numpy Generator end to end: same seed -> same genome/reads on any
platform."""

from __future__ import annotations

import numpy as np

from genome_tpu_torch.utils import dna

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(length: int, seed: int = 0, gc: float = 0.5) -> str:
    """Uniform-ish random genome string of the given length."""
    rng = np.random.default_rng(seed)
    p_at = (1.0 - gc) / 2
    p_gc = gc / 2
    codes = rng.choice(4, size=length, p=[p_at, p_gc, p_gc, p_at])
    return _BASES[codes].tobytes().decode("ascii")


def plant_repeats_codes(
    genome: np.ndarray,
    families: tuple[tuple[int, int], ...] = ((5000, 6), (1200, 10)),
    divergence: float = 0.002,
    seed: int = 1,
) -> np.ndarray:
    """Overwrite random positions of a uint8 code genome with near-identical
    copies of sampled segments (rRNA-operon / IS-element analog).

    families: (segment_length, extra_copies) pairs — each family samples one
    source segment and writes `extra_copies` diverged copies elsewhere. The
    defaults plant ~45 kb of repeat content into an E. coli-scale genome
    (~1%): one 5 kb "operon" at 7 total copies plus one 1.2 kb "IS element"
    at 11 — the long near-identical repeats that create collapsed chains and
    hard bubbles, which a uniform-random genome almost never has
    (SURVEY.md §4 fixtures; the reference's test sets are real E. coli).

    divergence: per-base substitution probability in each copy (~0.2%
    mimics inter-operon divergence; creates bubble structure at k=21).
    Copies may overlap each other — last write wins, as in real nested
    repeats. Deterministic for a given (genome, families, seed).
    """
    rng = np.random.default_rng(seed)
    g = genome.copy()
    n = g.size
    for seg_len, copies in families:
        if seg_len >= n:
            continue
        src = int(rng.integers(0, n - seg_len + 1))
        seg = g[src : src + seg_len].copy()
        for _ in range(copies):
            dst = int(rng.integers(0, n - seg_len + 1))
            cp = seg.copy()
            mut = rng.random(seg_len) < divergence
            bump = rng.integers(1, 4, size=seg_len).astype(np.uint8)
            cp = np.where(mut, (cp + bump) % 4, cp)
            g[dst : dst + seg_len] = cp
    return g


def plant_repeats(genome: str, **kw) -> str:
    """String-in/string-out wrapper over plant_repeats_codes."""
    g = plant_repeats_codes(dna.encode(genome), **kw)
    return _BASES[g].tobytes().decode("ascii")


def simulate_reads(
    genome: str,
    read_len: int = 100,
    coverage: float = 30.0,
    error_rate: float = 0.0,
    circular: bool = False,
    seed: int = 0,
    rc_fraction: float = 0.5,
) -> list[str]:
    """Uniformly sampled reads with optional substitution errors.

    Reads are sampled from both strands (each read reverse-complemented with
    probability rc_fraction). For circular genomes reads may wrap the origin.
    """
    rng = np.random.default_rng(seed)
    g = dna.encode(genome)
    n = len(g)
    if n < read_len and not circular:
        raise ValueError("genome shorter than read length")
    num_reads = int(np.ceil(coverage * n / read_len))
    if circular:
        starts = rng.integers(0, n, size=num_reads)
        idx = (starts[:, None] + np.arange(read_len)[None, :]) % n
        reads = g[idx]
    else:
        starts = rng.integers(0, n - read_len + 1, size=num_reads)
        reads = g[starts[:, None] + np.arange(read_len)[None, :]]
    reads = reads.astype(np.uint8)

    if error_rate > 0:
        err = rng.random(reads.shape) < error_rate
        # substitute with a *different* base: add 1..3 mod 4
        bump = rng.integers(1, 4, size=reads.shape).astype(np.uint8)
        reads = np.where(err, (reads + bump) % 4, reads)

    flip = rng.random(num_reads) < rc_fraction
    out: list[str] = []
    for i in range(num_reads):
        s = _BASES[reads[i]].tobytes().decode("ascii")
        out.append(dna.revcomp_str(s) if flip[i] else s)
    return out
