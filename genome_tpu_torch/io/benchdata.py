"""Shared benchmark workload (bench.py, parity artifacts, breakdown
scripts). One deterministic generator so the device pipeline, the golden
oracle, and every measurement script agree byte-for-byte on the input.

The RNG call order reproduces the round-2 bench.py exactly (same seed 0
streams), so headline numbers stay comparable across rounds.
"""

from __future__ import annotations

import hashlib

import numpy as np


def bench_workload(scale: float = 1.0, k: int = 21, read_len: int = 100,
                   coverage: int = 24, error_rate: float = 0.002,
                   seed: int = 0, batch: int = 4096,
                   repeats: bool = False) -> dict:
    """E. coli-scale simulated read set as uint8 code matrices.

    Returns dict with:
      clean: [num_padded, read_len] error-free codes (headline workload)
      err:   same reads with `error_rate` substitutions (e2e workload)
      num_reads, read_len, k, capacity, genome_len, n_windows
    Rows >= num_reads are padding (all-invalid code 4).

    repeats=True plants rRNA-operon/IS-style near-identical repeats
    (~1% of the genome; io/simulate.py plant_repeats_codes defaults)
    BEFORE sampling reads — the realistic-graph workload. Uses its own
    RNG stream so the legacy repeats=False byte streams (and therefore
    every cross-round headline/parity number) are untouched.
    """
    genome_len = int(4_600_000 * scale)
    num_reads = int(genome_len * coverage / read_len)
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    if repeats:
        from genome_tpu_torch.io.simulate import plant_repeats_codes
        genome = plant_repeats_codes(genome, seed=seed + 1)
    starts = rng.integers(0, genome_len - read_len + 1, size=num_reads)
    capacity = 1 << max(13, int(np.ceil(np.log2(genome_len * 1.5))))
    num_padded = ((num_reads + batch - 1) // batch) * batch
    clean = np.full((num_padded, read_len), 4, dtype=np.uint8)
    clean[:num_reads] = genome[starts[:, None] + np.arange(read_len)[None, :]]
    err = clean.copy()
    e = rng.random((num_reads, read_len)) < error_rate
    nerr = int(e.sum())
    err[:num_reads][e] = (
        (clean[:num_reads][e] + rng.integers(1, 4, nerr, dtype=np.uint8)) % 4)
    return dict(clean=clean, err=err, num_reads=num_reads,
                read_len=read_len, k=k, capacity=capacity,
                genome_len=genome_len, repeats=repeats,
                n_windows=num_reads * (read_len - k + 1))


def codes_to_reads(codes: np.ndarray, num_reads: int) -> list[str]:
    """Real rows of a code matrix -> read strings (for the golden oracle)."""
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    chars = lut[codes[:num_reads]]
    return [row.tobytes().decode("ascii") for row in chars]


def contigs_sha(contigs: list[str]) -> str:
    """Canonical digest of a contig set (sorted canonical strings)."""
    h = hashlib.sha256()
    for c in contigs:
        h.update(c.encode("ascii"))
        h.update(b"\n")
    return h.hexdigest()


def workload_key(w: dict, params_hash: str) -> str:
    """Cache key identifying (exact reads, exact semantics)."""
    h = hashlib.sha256()
    h.update(w["err"][: w["num_reads"]].tobytes())
    h.update(params_hash.encode())
    return h.hexdigest()[:24]
