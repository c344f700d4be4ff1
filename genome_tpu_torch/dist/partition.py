"""murmur3 fmix32, the owner hash of the k-mer key space (port of
genome_tpu/dist/partition.py::_fmix32_jnp and its constants).

Values are uint32 held in int64 tensors (this torch build's CPU backend
has no uint32 arithmetic). Every product is taken modulo 2^32 in 16-bit
halves, so nothing overflows int64.
"""

from __future__ import annotations

import torch

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for uint32 x (in int64) and a uint32 constant c."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser, elementwise over uint32 values."""
    x = x ^ (x >> 16)
    x = mul32(x, _C1)
    x = x ^ (x >> 13)
    x = mul32(x, _C2)
    return x ^ (x >> 16)
