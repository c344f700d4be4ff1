"""The yardstick of the kernels' rooflines: the card's peaks, and the
bytes a kernel must move, computed from its inputs.

`compaction_bytes` is a copy of chip_smoke.py's `_bound_bytes`, the
compaction's roofline arithmetic, frozen here so that a later per-call
roofline share (`compact_flagged_roofline`, which needs the bytes of
each call, a change to the program) takes its bytes from the benchmark
and not from the program. No metric reads it yet.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet, 700 W


def compaction_bytes(flags, arrays, capacity, sector: int = 0) -> int:
    """Bytes the compaction must move: the flags read once, each payload
    read only where flagged and kept (the kernel loads nothing else), each
    output slot written once (payloads + int64 pos) and the int64 total.
    sector > 0 counts payload reads in whole `sector`-byte sectors touched
    instead of elements."""
    import torch
    kf = flags & (torch.cumsum(flags, 0) <= capacity)
    kept = int(kf.sum())
    reads = 0
    for a in arrays:
        g = sector // a.element_size() if sector else 1
        pad = torch.zeros(-kf.numel() % g, dtype=torch.bool, device=kf.device)
        reads += int(torch.cat([kf, pad]).view(-1, g).any(1).sum()) \
            * a.element_size() * g
    return flags.numel() + reads \
        + kept * (sum(a.element_size() for a in arrays) + 8) + 8
