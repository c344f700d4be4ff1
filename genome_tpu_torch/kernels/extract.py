"""Read packing (host) + canonical k-mer window extraction (device).

Port of genome_tpu/kernels/extract.py. Windows become one int64 key each;
invalid windows (non-ACGT or padding) become SENTINEL (INT64_MAX), which
sorts after every real k-mer.

A code matrix goes to the device packed (`pack_codes_host`): 4 codes a
byte, plus a 1-bit validity mask that is left behind when the real
columns hold no code >= 4. The device unpacks it with uint8 shifts and
masks and cuts it to the first L columns, so the packed extractors give
exactly the uint8 path's R * (L - k + 1) keys, in the same order: the
pad columns, which decode as code 0, never reach a window.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_tpu_torch.io.native.cio import pack_codes_native
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


def pack_codes_host(codes: np.ndarray, pin_memory: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Host: uint8 code matrix [B, L] -> (packed [B, ceil(L/4)] uint8, 4
    codes a byte; invalid [B, ceil(L/8)] uint8, 1 bit a base for codes
    >= 4 and the pad columns; real_has_invalid), by the native packer
    writing straight into the two tensors, pinned if `pin_memory`.
    Upload `invalid` only when real_has_invalid is True."""
    B, L = codes.shape
    packed = torch.empty((B, -(-L // 4)), dtype=torch.uint8,
                         pin_memory=pin_memory)
    invalid = torch.empty((B, -(-L // 8)), dtype=torch.uint8,
                          pin_memory=pin_memory)
    _, _, has_invalid = pack_codes_native(
        codes, out=(packed.numpy(), invalid.numpy()))
    return packed, invalid, has_invalid


def _pack_codes_numpy(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Plain version of pack_codes_host's (packed, invalid), byte for byte
    the JAX package's numpy packer."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    L8 = -(-L // 8) * 8
    c = np.full((B, L8), PAD_CODE, dtype=np.uint8)
    c[:, :L] = codes
    bad = c >= 4
    c2 = (c & 3).astype(np.uint8)
    packed = (c2[:, 0::4] | (c2[:, 1::4] << 2) | (c2[:, 2::4] << 4)
              | (c2[:, 3::4] << 6))[:, : L4 // 4]
    weights = (1 << np.arange(8, dtype=np.uint8))
    invalid = (bad.reshape(B, L8 // 8, 8) * weights[None, None, :]).sum(
        axis=2).astype(np.uint8)
    return packed, invalid


def _unpack_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[B, w] uint8 -> [B, w * 8 / bits] uint8 fields of `bits` bits each,
    the low field first."""
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=x.device)
    return ((x.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)).reshape(
        x.shape[0], x.shape[1] * shifts.numel())


def extract_canonical_kmers_packed(packed: torch.Tensor,
                                   invalid: torch.Tensor, k: int,
                                   L: int) -> torch.Tensor:
    """extract_canonical_kmers on pack_codes_host's format: the codes of
    the first L columns, PAD_CODE where the mask bit is set."""
    codes = _unpack_bits(packed, 2)[:, :L]
    bad = _unpack_bits(invalid, 1)[:, :L].bool()
    return extract_canonical_kmers(codes.masked_fill(bad, PAD_CODE), k)


def extract_canonical_kmers_packed_nomask(packed: torch.Tensor, k: int,
                                          L: int) -> torch.Tensor:
    """extract_canonical_kmers_packed for inputs with no code >= 4 in the
    first L columns (pack_codes_host's real_has_invalid is False): the
    mask never crosses to the device."""
    return extract_canonical_kmers(_unpack_bits(packed, 2)[:, :L], k)


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
