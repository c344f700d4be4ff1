"""The benchmark's own FASTQ writer and FASTA reader (it reads back the
CLI's output with its own code, not the program's)."""

from __future__ import annotations

from pathlib import Path

import numpy as np

_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def write_fastq(path, codes: np.ndarray, block_rows: int = 1 << 18) -> int:
    """Write a code matrix as FASTQ (ids r<row>, zero-padded; quality I).
    Returns the bytes written."""
    n, L = codes.shape
    width = max(1, len(str(max(n - 1, 0))))
    hl = 2 + width + 1                     # "@r" + digits + "\n"
    rec = hl + L + 1 + 2 + L + 1           # seq "\n" "+\n" qual "\n"
    written = 0
    with open(path, "wb") as f:
        for r0 in range(0, n, block_rows):
            c = codes[r0 : r0 + block_rows]
            m = c.shape[0]
            out = np.empty((m, rec), dtype=np.uint8)
            out[:, 0], out[:, 1] = ord("@"), ord("r")
            idx = np.arange(r0, r0 + m, dtype=np.int64)
            for d in range(width):
                out[:, 2 + d] = ord("0") + (idx // 10 ** (width - 1 - d)) % 10
            out[:, hl - 1] = ord("\n")
            out[:, hl : hl + L] = _LUT[c]
            out[:, hl + L] = ord("\n")
            out[:, hl + L + 1] = ord("+")
            out[:, hl + L + 2] = ord("\n")
            out[:, hl + L + 3 : hl + 2 * L + 3] = ord("I")
            out[:, -1] = ord("\n")
            f.write(out.tobytes())
            written += out.size
    return written


def read_fasta(path) -> list[tuple[str, str]]:
    """(id, sequence) of every record of a plain FASTA file."""
    data = Path(path).read_bytes()
    if not data:
        return []
    if not data.startswith(b">"):
        raise ValueError(f"{path}: not FASTA")
    out = []
    for rec in data[1:].split(b"\n>"):
        header, _, body = rec.partition(b"\n")
        name = header.split()[0].decode() if header.strip() else ""
        out.append((name, body.replace(b"\n", b"").decode("ascii")))
    return out
