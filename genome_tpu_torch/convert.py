"""Carry state between the JAX package and the port.

Takes the JAX package's arrays as numpy ((hi, lo) uint32 key pairs,
uint32 counts, int32 ids) and returns the port's tensors (int64 keys,
int32 counts and ids), and back. With these a test can feed one JAX
stage's output into the next port stage. Imports neither JAX nor the JAX
package: callers hand over numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_tpu_torch.kernels.keys import keys_from_pair_np, pair_from_keys_np
from genome_tpu_torch.utils.device import resolve_device


def keys_from_pair(hi, lo, device="cuda") -> torch.Tensor:
    """(hi, lo) uint32 arrays -> int64 key tensor (SENTINEL preserved)."""
    return torch.from_numpy(keys_from_pair_np(hi, lo)).to(
        resolve_device(device))


def pair_from_keys(k) -> tuple[np.ndarray, np.ndarray]:
    """int64 key tensor or array -> (hi, lo) uint32 numpy arrays."""
    if torch.is_tensor(k):
        k = k.cpu().numpy()
    return pair_from_keys_np(k)


def table_from_jax(res: dict, device="cuda") -> dict:
    """A JAX count_kmers_device dict -> the port's table dict."""
    dev = resolve_device(device)
    return dict(
        table=keys_from_pair(np.asarray(res["table_hi"]),
                             np.asarray(res["table_lo"]), dev),
        counts=torch.from_numpy(
            np.asarray(res["counts"]).astype(np.int32)).to(dev),
        n_unique=torch.tensor(int(np.asarray(res["n_unique"])),
                              dtype=torch.int64, device=dev),
        overflow=torch.tensor(bool(np.asarray(res["overflow"])), device=dev))


def graph_from_jax(succ, okv_hi, okv_lo, device="cuda"):
    """JAX build outputs (succ [2C, 4] int32, okv pair) -> (succ, okv)."""
    dev = resolve_device(device)
    return (torch.from_numpy(np.array(succ, dtype=np.int32)).to(dev),
            keys_from_pair(np.asarray(okv_hi), np.asarray(okv_lo), dev))


def shard_rows(x, num_shards: int, device="cuda") -> list[torch.Tensor]:
    """A JAX global sharded array ([S * n, ...], shard r in rows r*n ..
    (r+1)*n - 1) -> one port tensor per rank, dtypes kept. A succ array
    keeps the JAX global oriented ids, which are the port's too."""
    dev = resolve_device(device)
    x = np.asarray(x)
    return [torch.from_numpy(np.array(p)).to(dev)
            for p in np.split(x, num_shards)]


def shard_keys_from_pair(hi, lo, num_shards: int,
                         device="cuda") -> list[torch.Tensor]:
    """JAX global sharded (hi, lo) key arrays [S * n] -> one int64 key
    tensor per rank."""
    return shard_rows(keys_from_pair_np(hi, lo), num_shards, device)
