"""Hash partition of the canonical k-mer key space (port of
genome_tpu/dist/partition.py; SEMANTICS §6b).

owner(kmer) = murmur3 fmix32 of the key's mixed uint32 halves
(kernels/keys.py::hash32), masked to the shard count, which must be a
power of two. The choice is invisible in the output (contigs do not
depend on the shard count) but every rank must compute it alike.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_tpu_torch.kernels.keys import _C1, _C2, hash32


def _check_shards(num_shards: int) -> None:
    if num_shards < 1 or num_shards & (num_shards - 1):
        raise ValueError(f"num_shards must be a power of 2, got {num_shards}")


def owner_of(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """int32 shard owning each int64 canonical k-mer (JAX owner_of)."""
    _check_shards(num_shards)
    return (hash32(keys) & (num_shards - 1)).to(torch.int32)


def _fmix32_np(x):
    x = x ^ (x >> np.uint32(16))
    x = (x * np.uint32(_C1)).astype(np.uint32)
    x = x ^ (x >> np.uint32(13))
    x = (x * np.uint32(_C2)).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return x


def owner_of_np(kmers_u64, num_shards: int) -> np.ndarray:
    """NumPy twin of owner_of, for tests and host planning."""
    _check_shards(num_shards)
    k = np.asarray(kmers_u64, dtype=np.uint64)
    hi = (k >> np.uint64(32)).astype(np.uint32)
    lo = (k & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mixed = lo ^ (hi * np.uint32(_C2)).astype(np.uint32)
    return (_fmix32_np(mixed) & np.uint32(num_shards - 1)).astype(np.int32)
