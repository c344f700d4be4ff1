"""Read packing (host) + canonical k-mer window extraction (device).

Port of genome_tpu/kernels/extract.py. Windows become one int64 key each;
invalid windows (non-ACGT or padding) become SENTINEL (INT64_MAX), which
sorts after every real k-mer.

A code matrix goes to the device packed (`pack_codes_host`): 4 codes a
byte, plus a 1-bit validity mask that is left behind when the real
columns hold no code >= 4. `extract_canonical_kmers_packed` turns that
format into exactly the uint8 path's R * (L - k + 1) keys, in the same
order: on the card by the hand-written kernel `csrc/extract.cu` (each
key made in registers from the packed bits, one 8-byte store a window),
on the CPU by its plain version, which unpacks with uint8 shifts and
masks, cuts to the first L columns (the pad columns never reach a
window) and runs `extract_canonical_kmers`.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from genome_tpu_torch.io.native.cio import pack_codes_native
from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.utils import dna

PAD_CODE = 4  # same as dna.INVALID

# wrapper calls that launched the kernel (CUDA path only), by whether the
# mask went along ("mask") or not ("nomask"); each is one launch
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


def pack_reads(reads: list[str], length: int | None = None) -> np.ndarray:
    """Host: list of read strings -> uint8 code matrix [B, L], padded with 4.

    Reads longer than `length` are truncated; shorter ones padded (padding
    yields invalid windows, so semantics match per-read extraction).
    """
    if not reads:
        return np.full((0, length or 0), PAD_CODE, dtype=np.uint8)
    L = length or max(len(r) for r in reads)
    out = np.full((len(reads), L), PAD_CODE, dtype=np.uint8)
    for i, r in enumerate(reads):
        c = dna.encode(r)[:L]
        out[i, : c.size] = c
    return out


def pack_codes_host(codes: np.ndarray, pin_memory: bool = False
                    ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Host: uint8 code matrix [B, L] -> (packed [B, ceil(L/4)] uint8, 4
    codes a byte; invalid [B, ceil(L/8)] uint8, 1 bit a base for codes
    >= 4 and the pad columns; real_has_invalid), by the native packer
    writing straight into the two tensors, pinned if `pin_memory`.
    Upload `invalid` only when real_has_invalid is True."""
    B, L = codes.shape
    packed = torch.empty((B, -(-L // 4)), dtype=torch.uint8,
                         pin_memory=pin_memory)
    invalid = torch.empty((B, -(-L // 8)), dtype=torch.uint8,
                          pin_memory=pin_memory)
    _, _, has_invalid = pack_codes_native(
        codes, out=(packed.numpy(), invalid.numpy()))
    return packed, invalid, has_invalid


def _pack_codes_numpy(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Plain version of pack_codes_host's (packed, invalid), byte for byte
    the JAX package's numpy packer."""
    B, L = codes.shape
    L4 = -(-L // 4) * 4
    L8 = -(-L // 8) * 8
    c = np.full((B, L8), PAD_CODE, dtype=np.uint8)
    c[:, :L] = codes
    bad = c >= 4
    c2 = (c & 3).astype(np.uint8)
    packed = (c2[:, 0::4] | (c2[:, 1::4] << 2) | (c2[:, 2::4] << 4)
              | (c2[:, 3::4] << 6))[:, : L4 // 4]
    weights = (1 << np.arange(8, dtype=np.uint8))
    invalid = (bad.reshape(B, L8 // 8, 8) * weights[None, None, :]).sum(
        axis=2).astype(np.uint8)
    return packed, invalid


def _unpack_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """[B, w] uint8 -> [B, w * 8 / bits] uint8 fields of `bits` bits each,
    the low field first."""
    shifts = torch.arange(0, 8, bits, dtype=torch.uint8, device=x.device)
    return ((x.unsqueeze(-1) >> shifts) & ((1 << bits) - 1)).reshape(
        x.shape[0], x.shape[1] * shifts.numel())


def extract_canonical_kmers_packed_ref(packed: torch.Tensor,
                                       invalid: torch.Tensor | None, k: int,
                                       L: int) -> torch.Tensor:
    """Plain version of extract_canonical_kmers_packed: the codes of the
    first L columns, PAD_CODE where the mask bit is set (no mask: none
    is), through extract_canonical_kmers."""
    codes = _unpack_bits(packed, 2)[:, :L]
    if invalid is not None:
        bad = _unpack_bits(invalid, 1)[:, :L].bool()
        codes = codes.masked_fill(bad, PAD_CODE)
    return extract_canonical_kmers(codes, k)


def _check(packed, invalid, k, L, out):
    if packed.dtype != torch.uint8 or packed.dim() != 2 \
            or not packed.is_contiguous() or L < 0 \
            or packed.shape[1] != -(-L // 4):
        raise ValueError("packed must be a contiguous [B, ceil(L/4)] uint8 "
                         f"tensor; got {packed.dtype} {tuple(packed.shape)} "
                         f"for L={L}")
    B = packed.shape[0]
    if invalid is not None and (
            invalid.dtype != torch.uint8 or not invalid.is_contiguous()
            or tuple(invalid.shape) != (B, -(-L // 8))
            or invalid.device != packed.device):
        raise ValueError("invalid must be a contiguous [B, ceil(L/8)] uint8 "
                         "tensor on packed's device; got "
                         f"{invalid.dtype} {tuple(invalid.shape)} on "
                         f"{invalid.device}")
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31]; got {k}")
    n = B * max(L - k + 1, 0)
    if out is not None and (
            out.dtype != torch.int64 or out.dim() != 1
            or not out.is_contiguous() or out.shape[0] != n
            or out.device != packed.device):
        raise ValueError(f"out must be a contiguous 1-D int64 tensor of {n} "
                         "keys on packed's device; got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return n


def _lib():
    from genome_tpu_torch.kernels import cubuild
    lib = cubuild.load("extract")
    if not getattr(lib, "_typed", False):
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.extract_kmers_cuda.argtypes = [vp, vp, ll, ll, i, vp, vp]
        lib.extract_kmers_cuda.restype = i
        lib._typed = True
    return lib


def extract_canonical_kmers_packed(packed: torch.Tensor,
                                   invalid: torch.Tensor | None, k: int,
                                   L: int,
                                   out: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """extract_canonical_kmers on pack_codes_host's format: the canonical
    keys of the first L columns' windows, [B * (L - k + 1)] int64,
    row-major, SENTINEL where a window covers a set bit of `invalid`
    (None: no mask, for a chunk with no code >= 4).

    Writes into `out` (a contiguous slice of a larger stream) when given,
    and returns it. On a CUDA tensor it launches `csrc/extract.cu` on the
    current stream (counted in LAUNCHES, "mask" or "nomask"); on a CPU
    tensor it runs the plain version. There is no fallback between the
    two."""
    n = _check(packed, invalid, k, L, out)
    dev = packed.device
    if dev.type == "cpu":
        keys = extract_canonical_kmers_packed_ref(packed, invalid, k, L)
        return keys if out is None else out.copy_(keys)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if out is None:
        out = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    lib = _lib()
    args = (packed.data_ptr(),
            None if invalid is None else invalid.data_ptr(),
            packed.shape[0], L, k, out.data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.extract_kmers_cuda(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.extract_kmers_cuda(*args)
    if err != 0:
        raise RuntimeError(f"extract_kmers launch failed: cudaError {err}")
    LAUNCHES["nomask" if invalid is None else "mask"] += 1
    return out


def extract_canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """[B, L] uint8 codes -> flat canonical int64 k-mer stream [B*(L-k+1)],
    row-major (read, then window), invalid windows = SENTINEL."""
    B, L = codes.shape
    nwin = L - k + 1
    if nwin <= 0:
        return torch.full((0,), SENTINEL, dtype=torch.int64,
                          device=codes.device)
    c64 = codes.to(torch.int64)
    x = torch.zeros((B, nwin), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((B, nwin), dtype=torch.bool, device=codes.device)
    for t in range(k):  # k shifted adds over the [B, nwin] window grid
        c = c64[:, t : t + nwin]
        x = (x << 2) | (c & 3)
        bad |= c >= 4
    x = keys.canonical(x, k)
    return torch.where(bad, SENTINEL, x).reshape(-1)
