"""Stable B-way stream partition: the port of the Pallas TPU kernel
genome_tpu/kernels/partition.py::partition_by_bucket (`_move_kernel`) and
its `partition_by_bucket_auto` wrapper.

Each (bid, rem) pair with 0 <= bid < B moves rem into bucket bid's region
of a [B, bucket_cap] output, in stream order; pairs with any other bid are
dropped and counted nowhere, as in JAX (its uint32 row sort leaves them
past the last segment). On a CUDA tensor the wrapper launches the
hand-written kernel in `csrc/partition.cu` (one pass with a decoupled
look-back over each tile's row of bucket counts: one memset of the tile
states and one launch on the current stream, which also writes the
totals and the overflow flag); on a CPU tensor it runs the plain version
`partition_by_bucket_ref`. There is no fallback between the two. The
moving happens in the kernel: the CUDA path calls no sort, bincount or
library scatter.

What bounds it on an H100: bytes, bid read once and rem read and written
once; see PERF.md for its time beside that bound.

Contract differences from the TPU kernel: no `row_len` (the TPU's row
sort and DMA granularity; on Hopper the result does not depend on any
row length), any n, int32 or int64 bids and payloads moved bit for bit,
int64 totals. Kept: `bucket_cap % CHUNK == 0` and the conservative
overflow rule `any(totals > bucket_cap - CHUNK)`, so the flag equals
JAX's on every input; ranks at or past bucket_cap are never written, so
an overflowing bucket writes nothing outside its region.
"""

from __future__ import annotations

import collections
import ctypes

import torch

CHUNK = 1024          # the TPU's per-bucket DMA granularity (overflow rule)
MAX_BUCKETS = 4096    # the CUDA kernel's shared-memory budget
_DTYPES = (torch.int32, torch.int64)

# wrapper calls that launched the kernel (CUDA path only); each is one
# memset and one __global__ launch
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _check(bid, rem, num_buckets: int, bucket_cap: int) -> None:
    for name, a in (("bid", bid), ("rem", rem)):
        if a.dtype not in _DTYPES or a.dim() != 1 or not a.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32/int64 "
                             f"tensor; got {a.dtype} {tuple(a.shape)}")
    if rem.shape != bid.shape or rem.device != bid.device:
        raise ValueError("bid and rem must have one length and device")
    if not 1 <= num_buckets <= MAX_BUCKETS:
        raise ValueError(f"num_buckets must be in 1..{MAX_BUCKETS}, got "
                         f"{num_buckets}")
    if bucket_cap < CHUNK or bucket_cap % CHUNK:
        raise ValueError(f"bucket_cap must be a positive multiple of {CHUNK}"
                         f", got {bucket_cap}")


def _overflow(totals, bucket_cap: int):
    return (totals > bucket_cap - CHUNK).any()


def partition_by_bucket_ref(bid, rem, num_buckets: int, bucket_cap: int):
    """Plain version: bincount, a stable sort on the bucket and index
    writes. Same contract as partition_by_bucket; unwritten slots are
    zero here."""
    _check(bid, rem, num_buckets, bucket_cap)
    keep = (bid >= 0) & (bid < num_buckets)
    b = bid[keep].long()
    totals = torch.bincount(b, minlength=num_buckets)
    sb, order = torch.sort(b, stable=True)
    start = torch.cumsum(totals, 0) - totals
    rank = torch.arange(sb.numel(), device=b.device) - start[sb]
    fits = rank < bucket_cap
    out = torch.zeros(num_buckets, bucket_cap, dtype=rem.dtype,
                      device=rem.device)
    out[sb[fits], rank[fits]] = rem[keep][order][fits]
    return out, totals, _overflow(totals, bucket_cap)


def _lib():
    from genome_tpu_torch.kernels import cubuild
    lib = cubuild.load("partition")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.partition_tile_size.argtypes = []
        lib.partition_tile_size.restype = ll
        lib.partition_cuda.argtypes = [vp, i, vp, i, ll, i, ll, ll, vp, vp,
                                       vp, ll, vp]
        lib.partition_cuda.restype = i
        lib._tile = int(lib.partition_tile_size())
        lib._typed = True
    return lib


def partition_by_bucket(bid, rem, num_buckets: int, bucket_cap: int):
    """Stable B-way partition of (bid, rem) pairs into per-bucket regions.

    Args:
      bid: contiguous 1-D int32/int64 bucket ids; pairs outside
        [0, num_buckets) are dropped.
      rem: contiguous 1-D int32/int64 payloads of bid's length, moved bit
        for bit.
      num_buckets: B, 1..MAX_BUCKETS.
      bucket_cap: per-bucket region size, a positive multiple of CHUNK.

    Returns (out [B, bucket_cap] of rem's dtype, totals [B] int64,
    overflow = any(totals > bucket_cap - CHUNK), a 0-dim bool).
    out[b, :min(totals[b], bucket_cap)] holds bucket b's payloads in
    stream order; out[b, j] for j >= totals[b] is unspecified.
    """
    if bid.device.type == "cpu":
        return partition_by_bucket_ref(bid, rem, num_buckets, bucket_cap)
    if bid.device.type != "cuda":
        raise ValueError(f"unsupported device {bid.device}")
    _check(bid, rem, num_buckets, bucket_cap)
    dev = bid.device
    n = bid.shape[0]
    out = torch.empty(num_buckets, bucket_cap, dtype=rem.dtype, device=dev)
    if n == 0:
        totals = torch.zeros(num_buckets, dtype=torch.int64, device=dev)
        return out, totals, _overflow(totals, bucket_cap)
    lib = _lib()
    # the tiles start on the 16-byte line below bid's address
    shift = (bid.data_ptr() & 15) // bid.element_size()
    n_tiles = -(-(n + shift) // lib._tile)
    # the totals, then the overflow flag; the kernel's scratch words: the
    # next tile id, one 32-bit state a tile, then (16-byte aligned) a
    # uint16 count row and an int64 prefix row a tile, B rounded up to 8
    # wide
    result = torch.empty(num_buckets + 1, dtype=torch.int64, device=dev)
    states = (2 + (n_tiles + 1) // 2) & ~1
    scratch = torch.empty(states + n_tiles * -(-num_buckets // 8) * 10,
                          dtype=torch.int64, device=dev)
    args = (bid.data_ptr(), bid.element_size(), rem.data_ptr(),
            rem.element_size(), n, num_buckets, bucket_cap,
            bucket_cap - CHUNK, out.data_ptr(), result.data_ptr(),
            scratch.data_ptr(), scratch.numel(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.partition_cuda(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.partition_cuda(*args)
    if err != 0:
        raise RuntimeError(f"partition_by_bucket launch failed: cudaError "
                           f"{err}")
    LAUNCHES["partition_by_bucket"] += 1
    return (out, result[:num_buckets],
            result.view(torch.bool)[8 * num_buckets])
