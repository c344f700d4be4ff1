"""int64 k-mer keys (SEMANTICS.md §1), replacing the JAX (hi, lo) pair.

k is odd and <= 31, so a packed k-mer (first base at the MSB) is below
2^62 and one signed int64 holds it with numeric order == lexicographic
order. INT64_MAX is the invalid-window sentinel: it sorts after every
real key, as the JAX pair (0xFFFFFFFF, 0xFFFFFFFF) does. `>>` on int64
is arithmetic, so every shift that can see a set sign bit is masked.
"""

from __future__ import annotations

import numpy as np
import torch

INT64_MAX = (1 << 63) - 1
SENTINEL = INT64_MAX
_PAIR_SENT = np.uint32(0xFFFFFFFF)

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def kmer_mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def revcomp(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed int64 k-mers; matches
    utils.dna.revcomp_u64 for every k <= 31."""
    x = ~x
    # every mask has its top two bits clear, which drops the sign bits an
    # arithmetic right shift brings in
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    x = ((x >> 32) & _M32) | (x << 32)
    return (x >> (64 - 2 * k)) & kmer_mask(k)


def canonical(x: torch.Tensor, k: int) -> torch.Tensor:
    """min(kmer, revcomp(kmer)) elementwise (SEMANTICS §2)."""
    return torch.minimum(x, revcomp(x, k))


def keys_from_pair_np(hi, lo) -> np.ndarray:
    """(hi, lo) uint32 arrays -> int64 keys; the all-ones pair maps to
    INT64_MAX and (0xFFFFFFFF, 0xFFFFFFFF - j) to INT64_MAX - j (the JAX
    build's invalid-record keys)."""
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    sent = hi == _PAIR_SENT
    out = v.astype(np.int64)
    out[sent] = INT64_MAX - (0xFFFFFFFF - lo[sent].astype(np.int64))
    if (~sent & (v >= np.uint64(1 << 63))).any():
        raise ValueError("pair key does not fit in a signed int64")
    return out


def pair_from_keys_np(keys) -> tuple[np.ndarray, np.ndarray]:
    """int64 keys -> (hi, lo) uint32 arrays; inverse of keys_from_pair_np."""
    keys = np.asarray(keys, dtype=np.int64)
    near = keys > INT64_MAX - (1 << 32)
    hi = (keys >> 32).astype(np.uint32)
    lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    hi[near] = _PAIR_SENT
    lo[near] = (0xFFFFFFFF - (INT64_MAX - keys[near])).astype(np.uint32)
    return hi, lo
