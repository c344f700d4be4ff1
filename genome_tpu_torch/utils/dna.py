"""Host-side DNA encoding utilities (NumPy). Contract: SEMANTICS.md §1.

Base codes A=0 C=1 G=2 T=3, invalid=4. K-mers pack first-base-at-MSB into
uint64 so numeric order == lexicographic order. Device-side (int64)
equivalents live in genome_tpu_torch.kernels.keys.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, INVALID = 0, 1, 2, 3, 4
BASES = "ACGT"

# char -> code lookup (uppercase + lowercase ACGT; everything else invalid)
_CODE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _i, _b in enumerate(BASES):
    _CODE_LUT[ord(_b)] = _i
    _CODE_LUT[ord(_b.lower())] = _i

_U64 = np.uint64


def encode(seq: str | bytes) -> np.ndarray:
    """Sequence string -> uint8 code array (INVALID for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """uint8 code array -> string ('N' for invalid codes)."""
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    return lut[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp_str(seq: str) -> str:
    return seq.translate(str.maketrans("ACGTNacgtn", "TGCANtgcan"))[::-1]


def pack_kmer(codes: np.ndarray) -> int:
    """Pack k codes (k<=32, all valid) into a python int, first base at MSB."""
    v = 0
    for c in np.asarray(codes, dtype=np.uint64):
        v = (v << 2) | int(c)
    return v


def unpack_kmer(value: int, k: int) -> np.ndarray:
    out = np.empty(k, dtype=np.uint8)
    for i in range(k - 1, -1, -1):
        out[i] = value & 3
        value >>= 2
    return out


def kmer_to_str(value: int, k: int) -> str:
    return decode(unpack_kmer(value, k))


def str_to_kmer(s: str) -> int:
    codes = encode(s)
    if (codes >= 4).any():
        raise ValueError(f"non-ACGT base in k-mer {s!r}")
    return pack_kmer(codes)


def revcomp_u64(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed k-mers (uint64), SEMANTICS §1.

    Complement = bitwise NOT per 2-bit base; reversal = swap 2-bit groups via
    log-steps; then shift down so the first base lands at bit 2k-2.
    """
    x = np.asarray(kmers, dtype=_U64)
    x = ~x
    x = ((x >> _U64(2)) & _U64(0x3333333333333333)) | ((x & _U64(0x3333333333333333)) << _U64(2))
    x = ((x >> _U64(4)) & _U64(0x0F0F0F0F0F0F0F0F)) | ((x & _U64(0x0F0F0F0F0F0F0F0F)) << _U64(4))
    x = ((x >> _U64(8)) & _U64(0x00FF00FF00FF00FF)) | ((x & _U64(0x00FF00FF00FF00FF)) << _U64(8))
    x = ((x >> _U64(16)) & _U64(0x0000FFFF0000FFFF)) | ((x & _U64(0x0000FFFF0000FFFF)) << _U64(16))
    x = (x >> _U64(32)) | (x << _U64(32))
    return x >> _U64(64 - 2 * k)


def kmer_mask(k: int) -> np.uint64:
    return _U64((1 << (2 * k)) - 1) if k < 32 else _U64(0xFFFFFFFFFFFFFFFF)


def canonical_u64(kmers: np.ndarray, k: int) -> np.ndarray:
    """min(kmer, revcomp(kmer)) per element (SEMANTICS §2)."""
    x = np.asarray(kmers, dtype=_U64)
    return np.minimum(x, revcomp_u64(x, k))


def extract_kmers_u64(codes: np.ndarray, k: int) -> np.ndarray:
    """All valid (ACGT-only) windows of one read's codes -> packed uint64.

    Returns the *forward* (uncanonicalized) packed windows, invalid windows
    dropped. Vectorized rolling pack: k shifted adds.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    if n < k:
        return np.empty(0, dtype=_U64)
    nwin = n - k + 1
    acc = np.zeros(nwin, dtype=_U64)
    for t in range(k):
        acc = (acc << _U64(2)) | codes[t : t + nwin].astype(_U64)
    valid_base = codes < 4
    # window valid iff all k bases valid: sliding product via cumsum of invalids
    bad = np.cumsum(~valid_base)
    valid_win = (bad[k - 1 :] - np.concatenate([[0], bad[: nwin - 1]])) == 0
    return acc[valid_win]


def canonical_kmers_of_read(seq: str, k: int) -> np.ndarray:
    """Canonical packed k-mers of one read (drops invalid windows)."""
    return canonical_u64(extract_kmers_u64(encode(seq), k), k)
