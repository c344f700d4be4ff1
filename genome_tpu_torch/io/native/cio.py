"""ctypes binding for the native FASTA/FASTQ parser and code packer.

Port of genome_tpu/io/native/cio.py. `fastx_native.cpp` (the JAX
package's source, copied unchanged) is compiled with g++ at first use into
`genome_tpu_torch/_build/` (git-ignored), named by a digest of the source
and flags. The compiler writes a temporary file that is renamed into
place, so several processes may build at once.

There is no silent fallback: every native entry point raises
`NativeUnavailable` when g++ or the library is missing. The pure-Python
parser (`_parse_python`) is the plain version; only `--io python` and the
tests reach it.
"""

from __future__ import annotations

import contextlib
import ctypes
import gzip
import hashlib
import io
import mmap
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from genome_tpu_torch.assemble.metrics import span

SRC = Path(__file__).resolve().parent / "fastx_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-pthread", "-shared", "-fPIC", "-std=c++17")

_ERRORS = {
    -1: "empty input",
    -2: "not FASTA/FASTQ",
    -3: "truncated record",
    -4: "row overflow",
}

_loaded: dict[Path, ctypes.CDLL] = {}

_i64 = ctypes.c_int64
_ptr = ctypes.c_void_p
_SIGNATURES = {
    "gt_scan": [_ptr, _i64, ctypes.POINTER(_i64), ctypes.POINTER(_i64)],
    "gt_index": [_ptr, _i64, _ptr, _i64],
    "gt_parse_mt": [_ptr, _i64, _ptr, _i64, _ptr, _i64, _i64],
    "gt_pack_codes": [_ptr, _i64, _i64, _i64, _i64, _ptr, _ptr,
                      ctypes.POINTER(_i64), _i64],
}


class NativeUnavailable(RuntimeError):
    """The native library could not be built or loaded."""


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfastx_native-{digest[:12]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so.tmp")
    os.close(fd)
    try:
        r = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", tmp],
                           capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise NativeUnavailable(
            f"cannot run {CXX!r} to build the native FASTA/FASTQ parser "
            f"({e}); use --io python") from e
    if r.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(
            f"{CXX} failed to build {SRC.name} (rc {r.returncode}):\n"
            f"{r.stderr.strip()}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    path = lib_path()
    lib = _loaded.get(path)
    if lib is not None:
        return lib
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeUnavailable(f"cannot load {path}: {e}") from e
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = _i64
        fn.argtypes = argtypes
    _loaded[path] = lib
    return lib


def native_available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
    except NativeUnavailable:
        return False
    return True


def _check(path, rc: int) -> int:
    if rc < 0:
        raise ValueError(f"{path}: {_ERRORS.get(rc, f'parse error {rc}')}")
    return rc


@contextlib.contextmanager
def _mapped(path):
    """(address, size) of the file's bytes for the native calls: a private
    read-only map of a plain file (pages read lazily), the decompressed
    bytes of a .gz."""
    path = os.fspath(path)
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            buf = np.frombuffer(f.read(), dtype=np.uint8)
        yield buf.ctypes.data, buf.size
        return
    size = os.path.getsize(path)
    if size == 0:
        yield None, 0
        return
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        buf = np.frombuffer(mm, dtype=np.uint8)
        try:
            yield buf.ctypes.data, size
        finally:
            del buf  # release the export before the map closes


def _scan(lib, path, addr, n) -> tuple[int, int]:
    nrec, maxlen = _i64(), _i64()
    _check(path, lib.gt_scan(addr, n, ctypes.byref(nrec),
                             ctypes.byref(maxlen)))
    return nrec.value, maxlen.value


def _threads(threads: int | None) -> int:
    return threads or min(8, os.cpu_count() or 1)


def _parse_python(data: bytes, length: int | None) -> np.ndarray:
    """Plain version of parse_fastx_codes: the Python parser and encoder."""
    from genome_tpu_torch.io.fastx import _iter_fasta, _iter_fastq
    from genome_tpu_torch.kernels.extract import pack_reads

    text = io.TextIOWrapper(io.BytesIO(data))
    first = text.read(1)
    if not first:
        return np.full((0, length or 0), 4, dtype=np.uint8)
    if first == ">":
        seqs = [s for _, s in _iter_fasta(text)]
    elif first == "@":
        seqs = [s for _, s in _iter_fastq(text)]
    else:
        raise ValueError("not FASTA/FASTQ")
    return pack_reads(seqs, length)


def pack_codes_native(codes: np.ndarray, threads: int | None = None,
                      out: tuple[np.ndarray, np.ndarray] | None = None
                      ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Row-parallel packing of a [B, L] uint8 code matrix into the upload
    format: packed [B, ceil(L/4)] (4 codes a byte, the first in the low
    bits) and invalid [B, ceil(L/8)] (1 bit a base, set for codes >= 4
    and for the pad columns). Byte-identical to
    kernels/extract.py::_pack_codes_numpy.

    `out`: C-contiguous uint8 arrays of those shapes to write into (the
    pipeline passes pinned host memory). A non-contiguous input is copied;
    any other dtype raises. Returns (packed, invalid, real_has_invalid):
    the flag is True iff a code in the first L columns is >= 4, so the
    caller may skip the mask."""
    if codes.dtype != np.uint8 or codes.ndim != 2:
        raise TypeError(f"pack_codes_native takes a 2-D uint8 code matrix, "
                        f"not {codes.dtype} of shape {codes.shape}")
    lib = load()
    codes = np.ascontiguousarray(codes)
    B, L = codes.shape
    w4, w8 = -(-L // 4), -(-L // 8)
    if out is None:
        out = (np.empty((B, w4), np.uint8), np.empty((B, w8), np.uint8))
    for a, shape in zip(out, ((B, w4), (B, w8))):
        if (a.dtype != np.uint8 or a.shape != shape
                or not a.flags.c_contiguous or not a.flags.writeable):
            raise ValueError(f"pack_codes_native: output of {a.dtype} "
                             f"{a.shape}, need writable contiguous uint8 "
                             f"{shape}")
    packed, invalid = out
    flag = _i64(0)
    if B:
        got = lib.gt_pack_codes(codes.ctypes.data, B, L, w4, w8,
                                packed.ctypes.data, invalid.ctypes.data,
                                ctypes.byref(flag), _threads(threads))
        if got != B:
            raise RuntimeError(f"gt_pack_codes packed {got} of {B} rows")
    return packed, invalid, bool(flag.value)


def count_fastx_records(path) -> int:
    """Record count of a FASTA/FASTQ file."""
    lib = load()
    with _mapped(path) as (addr, n):
        return _scan(lib, path, addr, n)[0]


def parse_fastx_codes(path, length: int | None = None,
                      threads: int | None = None,
                      record_range: tuple[int, int] | None = None
                      ) -> np.ndarray:
    """FASTA/FASTQ file (.gz ok) -> uint8 code matrix [records, L]
    (A=0 C=1 G=2 T=3, other and padding 4).

    The file is mapped, its record boundaries indexed in one pass, and the
    records decoded on `threads` threads. `length` pins L (longer records
    are cut); by default L is the longest record of the WHOLE file, so
    range reads from different processes agree.

    record_range: half-open [lo, hi) record slice; only those records are
    decoded and returned (per-process shard ingest). The boundary scan
    still reads the whole file; the decode and the matrix are
    range-sized."""
    lib = load()
    with _mapped(path) as (addr, n):
        with span("parse.scan"):
            rows, maxlen = _scan(lib, path, addr, n)
        L = length if length is not None else maxlen
        lo, hi = 0, rows
        if record_range is not None:
            lo = min(max(0, record_range[0]), rows)
            hi = min(max(lo, record_range[1]), rows)
        out = np.empty((hi - lo, max(L, 1)), dtype=np.uint8)
        if hi > lo:
            offsets = np.empty((rows,), dtype=np.int64)
            with span("parse.index"):
                got = _check(path, lib.gt_index(addr, n, offsets.ctypes.data,
                                                rows))
            if got != rows:
                raise RuntimeError(f"{path}: scan counted {rows} records, "
                                   f"index {got}")
            sub = np.ascontiguousarray(offsets[lo:hi])
            with span("parse.decode"):
                _check(path, lib.gt_parse_mt(addr, n, sub.ctypes.data,
                                             hi - lo, out.ctypes.data,
                                             out.shape[1], _threads(threads)))
    return out[:, :L] if L else out
