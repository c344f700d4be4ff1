"""Read packing (host) + canonical k-mer window extraction (device).

Port of genome_tpu/kernels/extract.py (`pack_reads`,
`extract_canonical_kmers`). Windows become one int64 key each; invalid
windows (non-ACGT or padding) become SENTINEL (INT64_MAX), which sorts
after every real k-mer. Codes go to the device as uint8 (the packed and
mask-free upload variants are a later slice's work).
"""

from __future__ import annotations

import numpy as np
import torch

from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.utils import dna

PAD_CODE = 4  # same as dna.INVALID


def pack_reads(reads: list[str], length: int | None = None) -> np.ndarray:
    """Host: list of read strings -> uint8 code matrix [B, L], padded with 4.

    Reads longer than `length` are truncated; shorter ones padded (padding
    yields invalid windows, so semantics match per-read extraction).
    """
    if not reads:
        return np.full((0, length or 0), PAD_CODE, dtype=np.uint8)
    L = length or max(len(r) for r in reads)
    out = np.full((len(reads), L), PAD_CODE, dtype=np.uint8)
    for i, r in enumerate(reads):
        c = dna.encode(r)[:L]
        out[i, : c.size] = c
    return out


def extract_canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] uint8 codes -> flat canonical int64 k-mer stream [B*(L-k+1)],
    row-major (read, then window), invalid windows = SENTINEL."""
    B, L = codes.shape
    nwin = L - k + 1
    if nwin <= 0:
        return torch.full((0,), SENTINEL, dtype=torch.int64,
                          device=codes.device)
    c64 = codes.to(torch.int64)
    x = torch.zeros((B, nwin), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((B, nwin), dtype=torch.bool, device=codes.device)
    for t in range(k):  # k shifted adds over the [B, nwin] window grid
        c = c64[:, t : t + nwin]
        x = (x << 2) | (c & 3)
        bad |= c >= 4
    x = keys.canonical(x, k)
    return torch.where(bad, SENTINEL, x).reshape(-1)
