"""Bitonic block sort and merge: the port of the Pallas TPU kernels
genome_tpu/kernels/bitonic.py::sort_blocks (`_sort_kernel`) and
merge_blocks (`_merge_kernel`).

Each contiguous `block`-element run of a tuple of arrays is sorted
ascending, lexicographically on the first `num_keys` arrays, the rest
carried. `merge_blocks` runs only the last phase (distances block/2 ... 1)
and so sorts runs that are already bitonic. On a CUDA tensor the wrapper
launches the hand-written kernels in `csrc/bitonic.cu` (a register-resident
tile for the stages at distances below the tile, one grid-wide launch per
stage above it); on a CPU tensor it runs the plain versions
`sort_blocks_ref` / `merge_blocks_ref`. There is no fallback between the
two.

Both forms run the TPU kernel's network stage for stage: partner i ^ j,
phase direction from bit kk of the in-block index, and its tie rule
`take_partner = (~flip & gt) | (flip & ~gt & ~eq)`, i.e. a pair swaps only
when strictly out of order. So both give the JAX output exactly, payloads
among equal keys included. Comparisons are signed (the JAX kernels compare
uint32): feed values below 2^31 as int32, or a (hi, lo) pair as one int64
key.

What bounds it on an H100: the log2(block)^2 / 2 compare-exchange stages.
The tile kernel holds a tile of every array in registers, widened to
int64, and runs the stages below the tile there: within a thread's
registers, across lanes by warp shuffles, and across warps after a
re-layout through shared memory, twice per phase that reaches the warp
bits instead of a shared-memory trip and a barrier per stage. Each stage
at or above the tile is still one grid-wide trip through device memory.
See PERF.md for its time beside the one-read, one-write bandwidth bound
and the split by launch.
"""

from __future__ import annotations

import collections
import ctypes

import torch

MAX_ARRAYS = 4
_DTYPES = (torch.int32, torch.int64)

# wrapper calls that launched the kernels, by function (CUDA path only);
# each call is one or more __global__ launches (see csrc/bitonic.cu)
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _check(arrays, num_keys: int, block: int) -> tuple:
    arrays = tuple(arrays)
    if not 1 <= len(arrays) <= MAX_ARRAYS:
        raise ValueError(f"1 to {MAX_ARRAYS} arrays, got {len(arrays)}")
    if num_keys not in (1, 2) or num_keys > len(arrays):
        raise ValueError(f"num_keys must be 1 or 2 (<= arrays), got {num_keys}")
    if block < 256 or block & (block - 1):
        raise ValueError(f"block must be a power of two >= 256, got {block}")
    n = arrays[0].shape[0] if arrays[0].dim() == 1 else -1
    for a in arrays:
        if a.dtype not in _DTYPES or a.dim() != 1 or a.shape[0] != n \
                or not a.is_contiguous() or a.device != arrays[0].device:
            raise ValueError(
                "arrays must be contiguous 1-D int32/int64 tensors of one "
                f"length and device; got {a.dtype} {tuple(a.shape)} on "
                f"{a.device}")
    if n % block:
        raise ValueError(f"length {n} is not a multiple of block {block}")
    return arrays


def _stage_ref(xs, num_keys: int, j: int, kk: int, block: int) -> list:
    """One compare-exchange stage at distance j in phase kk: pairs
    (i, i + j) with bit j of i clear, descending where bit kk of the
    in-block index is set (never for kk == block)."""
    groups = block // (2 * j)
    views = [x.view(-1, groups, 2, j) for x in xs]
    lo = [v[:, :, 0] for v in views]
    hi = [v[:, :, 1] for v in views]
    gt = lo[0] > hi[0]
    eq = lo[0] == hi[0]
    for w in range(1, num_keys):
        gt = gt | (eq & (lo[w] > hi[w]))
        eq = eq & (lo[w] == hi[w])
    g = torch.arange(groups, device=xs[0].device) * (2 * j)
    desc = ((g & kk) != 0).view(1, groups, 1)
    swap = torch.where(desc, ~gt & ~eq, gt)
    return [torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)],
                        dim=2).reshape(-1) for a, b in zip(lo, hi)]


def _network_ref(arrays, num_keys: int, block: int, merge_only: bool):
    if arrays[0].shape[0] == 0:
        return tuple(a.clone() for a in arrays)
    xs = list(arrays)
    kk = block if merge_only else 2
    while kk <= block:
        j = kk // 2
        while j >= 1:
            xs = _stage_ref(xs, num_keys, j, kk, block)
            j //= 2
        kk *= 2
    return tuple(xs)


def sort_blocks_ref(arrays, num_keys: int, block: int) -> tuple:
    """Plain version of sort_blocks: the same network in torch ops."""
    arrays = _check(arrays, num_keys, block)
    return _network_ref(arrays, num_keys, block, merge_only=False)


def merge_blocks_ref(arrays, num_keys: int, block: int) -> tuple:
    """Plain version of merge_blocks: the kk = block phase in torch ops."""
    arrays = _check(arrays, num_keys, block)
    return _network_ref(arrays, num_keys, block, merge_only=True)


def _lib():
    from genome_tpu_torch.kernels import cubuild
    lib = cubuild.load("bitonic")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bitonic_tile.argtypes = [i, ll]
        lib.bitonic_tile.restype = ll
        lib.bitonic_cuda.argtypes = [
            ll, i, ctypes.POINTER(vp), ctypes.POINTER(vp), ctypes.POINTER(i),
            i, ll, i, vp]
        lib.bitonic_cuda.restype = i
        lib._typed = True
    return lib


def tile_size(arrays, block: int) -> int:
    """The tile the CUDA kernels use for these arrays: min(block, TILE),
    TILE 16384 for one array, 8192 for two, 4096 for three or four."""
    return int(_lib().bitonic_tile(len(arrays), block))


def _launch(name: str, arrays: tuple, num_keys: int, block: int,
            merge_only: bool) -> tuple:
    lib = _lib()
    dev = arrays[0].device
    n = arrays[0].shape[0]
    outs = tuple(torch.empty_like(a) for a in arrays)
    k = len(arrays)
    srcs = (ctypes.c_void_p * k)(*[a.data_ptr() for a in arrays])
    dsts = (ctypes.c_void_p * k)(*[o.data_ptr() for o in outs])
    sizes = (ctypes.c_int * k)(*[a.element_size() for a in arrays])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bitonic_cuda(n, k, srcs, dsts, sizes, num_keys, block,
                               int(merge_only), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return outs


def _dispatch(name, arrays, num_keys, block, merge_only):
    arrays = _check(arrays, num_keys, block)
    dev = arrays[0].device
    if dev.type == "cpu":
        return _network_ref(arrays, num_keys, block, merge_only)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if arrays[0].shape[0] == 0:
        return tuple(a.clone() for a in arrays)
    return _launch(name, arrays, num_keys, block, merge_only)


def sort_blocks(arrays, num_keys: int, block: int) -> tuple:
    """Sort each contiguous `block`-element run ascending.

    Args:
      arrays: tuple of 1 to 4 contiguous 1-D int32/int64 tensors of one
        length n, n % block == 0.
      num_keys: 1 or 2; lexicographic on arrays[:num_keys], the rest
        carried.
      block: a power of two >= 256.

    Returns the sorted tuple (new tensors). Equal keys end in the order
    the network leaves them, which is the TPU kernel's order."""
    return _dispatch("sort_blocks", arrays, num_keys, block, False)


def merge_blocks(arrays, num_keys: int, block: int) -> tuple:
    """Sort each `block`-run ascending, assuming each run is bitonic (the
    in-block tail of one merge level). Same contract as sort_blocks."""
    return _dispatch("merge_blocks", arrays, num_keys, block, True)
