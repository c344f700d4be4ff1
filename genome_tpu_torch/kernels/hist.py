"""Streaming digit histogram: the port of the Pallas TPU kernel
genome_tpu/kernels/pallas_hist.py::digit_histogram (`_hist_kernel`) and its
`digit_histogram_auto` wrapper.

Counts the digit (key >> shift) & (2^nbits - 1) over a stream of int64
keys. On a CUDA tensor the wrapper calls the hand-written kernel in
`csrc/hist.cu`: one memset of the output and one launch on the caller's
stream. Each block counts into shared-memory counters, one plain atomic
add a key, and adds them into the output with global atomics at the end;
at 16 bits a thread block cluster of two splits the counters, each block
reading its keys once and passing their digits to the other through
distributed shared memory. On a CPU tensor it runs the plain version
`digit_histogram_ref`. There is no fallback between the two.

The digit is taken from the JAX package's 64-bit (hi, lo) value of each
key: the port's sentinel keys (above INT64_MAX - 2^32, see keys.py) stand
for JAX pairs with hi = 0xFFFFFFFF, so bit 63 is set for them first. The
two forms then differ in no bit, and padding lands in the JAX kernel's bin
wherever the digit covers bit 63.

What bounds it on an H100: memory bandwidth, the keys read once; see
PERF.md for its time beside that bound.

Contract differences from the TPU kernel: any n (no 32768-key tiling),
int64 counts.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from genome_tpu_torch.kernels.keys import INT64_MAX

MAX_BITS = 16
_NEAR_SENTINEL = INT64_MAX - (1 << 32)  # keys above it are JAX pairs
_BIT63 = -(1 << 63)                     # with hi = 0xFFFFFFFF

# wrapper calls that launched the kernel (CUDA path only); each is one
# memset and one __global__ launch
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def _check(keys, nbits: int, shift: int) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int64 tensor; got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if not 1 <= nbits <= MAX_BITS:
        raise ValueError(f"nbits must be in 1..{MAX_BITS}, got {nbits}")
    if shift < 0 or shift + nbits > 64:
        raise ValueError(f"need 0 <= shift and shift + nbits <= 64; got "
                         f"shift {shift}, nbits {nbits}")


def digits_ref(keys, nbits: int, shift: int) -> torch.Tensor:
    """The int64 digit of each key, bit 63 set for sentinels first. `>>`
    is arithmetic, but shift + nbits <= 64 keeps the sign copies out of
    the mask."""
    u = torch.where(keys > _NEAR_SENTINEL, keys | _BIT63, keys)
    return (u >> shift) & ((1 << nbits) - 1)


def digit_histogram_ref(keys, nbits: int = 8, shift: int = 0):
    """Plain version: the digits, then torch.bincount. Same contract as
    digit_histogram."""
    _check(keys, nbits, shift)
    return torch.bincount(digits_ref(keys, nbits, shift),
                          minlength=1 << nbits)


def _lib():
    from genome_tpu_torch.kernels import cubuild
    lib = cubuild.load("hist")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.digit_histogram_cuda.argtypes = [vp, ll, i, i, vp, vp]
        lib.digit_histogram_cuda.restype = i
        lib._typed = True
    return lib


def digit_histogram(keys, nbits: int = 8, shift: int = 0):
    """Histogram of (key >> shift) & (2^nbits - 1) over the key stream.

    Args:
      keys: contiguous 1-D int64 keys (keys.py form; sentinels count as
        the JAX pair with hi = 0xFFFFFFFF), any length.
      nbits: 1..16 digit bits.
      shift: digit position, shift + nbits <= 64.

    Returns int64 counts [2^nbits], summing to n.
    """
    if keys.device.type == "cpu":
        return digit_histogram_ref(keys, nbits, shift)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    _check(keys, nbits, shift)
    dev = keys.device
    n = keys.shape[0]
    if n == 0:
        return torch.zeros(1 << nbits, dtype=torch.int64, device=dev)
    lib = _lib()
    # the kernel's entry point zeroes it on the stream
    out = torch.empty(1 << nbits, dtype=torch.int64, device=dev)
    args = (keys.data_ptr(), n, nbits, shift, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.digit_histogram_cuda(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.digit_histogram_cuda(*args)
    if err != 0:
        raise RuntimeError(f"digit_histogram launch failed: cudaError {err}")
    LAUNCHES["digit_histogram"] += 1
    return out
