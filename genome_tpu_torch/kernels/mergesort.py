"""Global merge sort of int64 keys: bitonic block sort + bitonic merge
levels. Port of genome_tpu/kernels/mergesort.py::sort_pairs_merge, which
has no `pallas_call` of its own: it composes the two kernels of
kernels/bitonic.py.

- block sort: `sort_blocks` sorts `block`-element runs of the real prefix;
- merge levels: runs merge pairwise. Each level is one "mirror" stage (the
  half-cleaner pairing i <-> 2L-1-i) and the halving stages at distances
  >= block, both plain torch elementwise ops (XLA ops in JAX), then ONE
  `merge_blocks` call for all in-block halving stages;
- a non-power-of-two block count pads with INT64_MAX blocks, and every
  level touches only the prefix of runs holding real data.

The JAX (hi, lo) pair is one int64 key here (num_keys=1). The sorter
contract of kernels/count.py holds: the output is fully ascending.
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels.bitonic import merge_blocks, sort_blocks
from genome_tpu_torch.kernels.keys import SENTINEL


def _mirror(x: torch.Tensor, L: int) -> torch.Tensor:
    """Half-cleaner over each 2L run: pair i <-> 2L-1-i, mins to the first
    half (order kept), maxs to the second half (order kept)."""
    x2 = x.view(-1, 2, L)
    a, b = x2[:, 0], x2[:, 1].flip(-1)
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b).flip(-1)],
                       dim=1).reshape(-1)


def _halve(x: torch.Tensor, d: int) -> torch.Tensor:
    """Bitonic halving stage at distance d over every 2d segment."""
    x2 = x.view(-1, 2, d)
    a, b = x2[:, 0], x2[:, 1]
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b)],
                       dim=1).reshape(-1)


def sort_pairs_merge(keys: torch.Tensor, block: int = 65536) -> torch.Tensor:
    """Full ascending sort of a 1-D int64 key stream, len % block == 0.

    Returns the sorted keys (a new tensor)."""
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("keys must be a 1-D int64 tensor")
    n = keys.shape[0]
    if n % block:
        raise ValueError(f"length {n} is not a multiple of block {block}")
    if n == 0:
        return keys.clone()
    nb = n // block
    nbp = 1 << max(0, (nb - 1).bit_length())
    # block sort only the real prefix; the sentinel tail is constant
    (s,) = sort_blocks((keys.contiguous(),), 1, block)
    if nbp != nb:
        s = torch.cat([s, s.new_full(((nbp - nb) * block,), SENTINEL)])
    L = block
    while L < nbp * block:
        active = -(-nb * block // (2 * L)) * 2 * L  # 2L-runs with real data
        a = _mirror(s[:active], L)
        d = L // 2
        while d >= block:
            a = _halve(a, d)
            d //= 2
        (a,) = merge_blocks((a,), 1, block)
        s[:active] = a  # s is this function's own buffer
        L *= 2
    return s[:n]
