"""Ordered stream compaction: the port of the Pallas TPU kernel
genome_tpu/kernels/compact.py::compact_flagged (`_compact_kernel`) and its
`compact_ids` wrapper.

Flagged elements of a stream, with any number (<= 6) of carried arrays,
go densely and in order to the front of `capacity`-slot outputs, with
their source positions and the exact flagged total. On a CUDA tensor the
wrapper launches the hand-written kernel in `csrc/compact.cu` (three
launches on the current stream: per-tile counts, one-block offset scan,
ranked scatter); on a CPU tensor it runs the plain version
`compact_flagged_ref`. There is no fallback between the two.

What bounds it on an H100: memory bandwidth. The flags and each payload
are read once and each output element is written once; there is no
arithmetic to speak of. See PERF.md for its time beside that bound.

Contract differences from the TPU kernel: no padding of n, no capacity
alignment, `overflow` is exactly `total > capacity`. As there, output
slots >= total are unspecified: mask downstream.
"""

from __future__ import annotations

import collections
import ctypes

import torch

MAX_ARRAYS = 6
_DTYPES = (torch.int32, torch.int64)

# call-site labels on the main path (JAX file:line of each site)
SITES = {
    "count_heads": "kernels/count.py:159",
    "count_filter": "kernels/count.py:194",
    "build": "graph/build.py:264",
    "tips": "graph/simplify.py:346",
    "bubbles": "graph/simplify.py:376",
    "kills": "graph/simplify.py:517",
    "tails": "graph/simplify.py:984",
    "contig_starts": "graph/contigs.py:104",
}

# wrapper calls that launched the kernel, per call-site label (CUDA path
# only); each call is three __global__ launches (one when n == 0)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _check(flags, arrays, capacity):
    if flags.dtype != torch.bool or flags.dim() != 1 \
            or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous 1-D bool tensor")
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"at most {MAX_ARRAYS} carried arrays")
    n = flags.shape[0]
    for a in arrays:
        if a.dtype not in _DTYPES or a.shape != (n,) \
                or not a.is_contiguous() or a.device != flags.device:
            raise ValueError(
                "carried arrays must be contiguous 1-D int32/int64 tensors "
                f"of the flags' length and device; got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
    if capacity < 0:
        raise ValueError("capacity must be >= 0")


def compact_flagged_ref(flags, arrays, capacity: int):
    """Plain version: cumsum of the flags plus index writes (the JAX CPU
    branch, kernels/compact.py:260-265). Same contract as compact_flagged;
    unwritten slots are zero here."""
    _check(flags, arrays, capacity)
    n = flags.shape[0]
    dev = flags.device
    dest = torch.cumsum(flags, 0, dtype=torch.int64) - 1
    scat = torch.where(flags & (dest < capacity), dest, capacity)
    outs = []
    for a in list(arrays) + [torch.arange(n, dtype=torch.int64, device=dev)]:
        o = torch.zeros(capacity + 1, dtype=a.dtype, device=dev)
        o.scatter_(0, scat, a)
        outs.append(o[:capacity])
    total = flags.sum(dtype=torch.int64)
    return tuple(outs[:-1]), outs[-1], total, total > capacity


def _lib():
    from genome_tpu_torch.kernels import cubuild
    lib = cubuild.load("compact")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.compact_tile_size.argtypes = []
        lib.compact_tile_size.restype = ll
        lib.compact_flagged_cuda.argtypes = [
            vp, ll, i, ctypes.POINTER(vp), ctypes.POINTER(vp),
            ctypes.POINTER(i), vp, ll, vp, vp, vp, vp]
        lib.compact_flagged_cuda.restype = i
        lib._typed = True
    return lib


def compact_flagged(flags, arrays, capacity: int, site: str = "direct"):
    """Dense, in-order extraction of flagged stream elements.

    Args:
      flags: contiguous bool (n,).
      arrays: tuple of contiguous int32/int64 (n,) carried values (<= 6).
      capacity: output slots; flagged elements past it are dropped.
      site: call-site label for the launch counter (LAUNCHES).

    Returns (outs tuple, pos, total, overflow): outs[i][:total] are
    arrays[i] at the flagged positions (ascending), pos[:total] those
    positions (int64), total the exact flagged count (0-dim int64, may exceed
    capacity), overflow = total > capacity (0-dim bool). Slots >= total
    are unspecified.
    """
    arrays = tuple(arrays)
    if flags.device.type == "cpu":
        return compact_flagged_ref(flags, arrays, capacity)
    if flags.device.type != "cuda":
        raise ValueError(f"unsupported device {flags.device}")
    _check(flags, arrays, capacity)
    lib = _lib()
    dev = flags.device
    n = flags.shape[0]
    nt = -(-n // int(lib.compact_tile_size()))
    outs = tuple(torch.empty(capacity, dtype=a.dtype, device=dev)
                 for a in arrays)
    pos = torch.empty(capacity, dtype=torch.int64, device=dev)
    tile_counts = torch.empty(nt, dtype=torch.int32, device=dev)
    offsets = torch.empty(nt, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    k = len(arrays)
    srcs = (ctypes.c_void_p * max(k, 1))(*[a.data_ptr() for a in arrays])
    dsts = (ctypes.c_void_p * max(k, 1))(*[o.data_ptr() for o in outs])
    sizes = (ctypes.c_int * max(k, 1))(*[a.element_size() for a in arrays])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.compact_flagged_cuda(
            flags.data_ptr(), n, k, srcs, dsts, sizes, pos.data_ptr(),
            capacity, tile_counts.data_ptr(),
            offsets.data_ptr(), total.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"compact_flagged launch failed: cudaError {err}")
    LAUNCHES[site] += 1
    total = total[0]
    return outs, pos, total, total > capacity


def compact_ids(flags, M: int, site: str = "direct"):
    """Positions of set flags, compacted to an M-slot id buffer (in order).

    Returns (ids[M] int64 — unspecified beyond the real count, n (0-dim
    int64), overflow = n > M)."""
    _, pos, total, ovf = compact_flagged(flags, (), M, site=site)
    return pos, total, ovf
