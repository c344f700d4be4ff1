"""FASTA/FASTQ reading + FASTA writing (reference analog: read ingestion,
SURVEY.md §2.1 R1). Pure-Python streaming parser; a C++ fast path can be
swapped in behind the same API (a later slice ports the native parser)."""

from __future__ import annotations

import gzip
import io
import os
from collections.abc import Iterator


def _open_text(path: str | os.PathLike):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_fastx(path: str | os.PathLike) -> Iterator[tuple[str, str]]:
    """Yield (id, sequence) from FASTA or FASTQ (auto-detected, .gz ok)."""
    with _open_text(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == ">":
            yield from _iter_fasta(f)
        elif first == "@":
            yield from _iter_fastq(f)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _iter_fasta(f) -> Iterator[tuple[str, str]]:
    # f is positioned just after the first '>'
    first = f.readline().strip()
    name = first.split()[0] if first else ""
    chunks: list[str] = []
    for line in f:
        if line.startswith(">"):
            yield name, "".join(chunks)
            name = line[1:].strip().split()[0] if line[1:].strip() else ""
            chunks = []
        else:
            chunks.append(line.strip())
    yield name, "".join(chunks)


def _iter_fastq(f) -> Iterator[tuple[str, str]]:
    # f is positioned just after the first '@'
    while True:
        header = f.readline()
        if not header:
            return
        seq = f.readline().strip()
        plus = f.readline()
        qual = f.readline()
        if not qual:
            raise ValueError("truncated FASTQ record")
        assert plus.startswith("+"), "malformed FASTQ"
        hs = header.strip()
        name = hs.split()[0] if hs else ""
        yield name, seq
        nxt = f.read(1)
        if not nxt:
            return
        assert nxt == "@", "malformed FASTQ"


def read_fastx(path: str | os.PathLike) -> list[str]:
    """All sequences of a FASTA/FASTQ file."""
    return [seq for _, seq in iter_fastx(path)]


def write_fasta(path: str | os.PathLike, seqs: list[str],
                ids: list[str] | None = None, width: int = 80,
                index: bool = False) -> None:
    """Write sequences as FASTA (ids default to contig_{i}, SEMANTICS §6).

    `.gz` paths are gzip-compressed. With index=True (plain paths only),
    a samtools-compatible `.fai` index is written alongside:
    name, length, byte offset of first base, bases/line, bytes/line.
    """
    path = os.fspath(path)
    gz = path.endswith(".gz")
    fai: list[str] = []
    f = io.TextIOWrapper(gzip.open(path, "wb")) if gz else open(path, "w")
    with f:
        offset = 0
        for i, s in enumerate(seqs):
            name = ids[i] if ids is not None else f"contig_{i}"
            header = f">{name}\n"
            f.write(header)
            offset += len(header)
            fai.append(f"{name}\t{len(s)}\t{offset}\t{width}\t{width + 1}\n")
            for j in range(0, len(s), width):
                line = s[j : j + width] + "\n"
                f.write(line)
                offset += len(line)
    if index and not gz:
        with open(path + ".fai", "w") as fx:
            fx.writelines(fai)
