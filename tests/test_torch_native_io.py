"""The port's native FASTA/FASTQ parser, code packer and packed extractors
against the JAX package on the same inputs (exact: the same bytes, the
same keys), and the native entry points' refusal to fall back."""

import gzip

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.io.native import cio as jax_cio
from genome_tpu.kernels import extract as jax_extract
from genome_tpu_torch import convert
from genome_tpu_torch.assemble import cli
from genome_tpu_torch.assemble.pipeline import extract_stream
from genome_tpu_torch.io.native import cio
from genome_tpu_torch.kernels.extract import (
    _pack_codes_numpy, extract_canonical_kmers,
    extract_canonical_kmers_packed, pack_codes_host, pack_reads)

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _write_fastq(path, reads, meta=" extra meta"):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}{meta}\n{r}\n+\n{'I' * len(r)}\n")


def _assert_parse_equal(path, **kw):
    """The port's parse equals the JAX package's, byte for byte."""
    got = cio.parse_fastx_codes(str(path), **kw)
    want = jax_cio.parse_fastx_codes(str(path), **kw)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)
    return got


def _fastq(tmp_path):
    reads = simulate_reads(random_genome(500, seed=1), read_len=80,
                           coverage=5, seed=2)
    reads[3] = reads[3][:20] + "NnxX" + reads[3][24:]  # odd letters
    reads[7] = reads[7][:33]  # a short record
    p = tmp_path / "r.fastq"
    _write_fastq(p, reads)
    return p, reads


def test_fastq_matches_jax_and_python(tmp_path):
    p, reads = _fastq(tmp_path)
    got = _assert_parse_equal(p)
    assert np.array_equal(got, pack_reads(reads))
    assert np.array_equal(cio._parse_python(p.read_bytes(), None), got)
    assert cio.count_fastx_records(str(p)) == \
        jax_cio.count_fastx_records(str(p)) == len(reads)


def test_fasta_multiline_matches_jax(tmp_path):
    p = tmp_path / "g.fasta"
    g1, g2 = random_genome(137, seed=3), random_genome(61, seed=4)
    with open(p, "w") as f:
        f.write(">a desc\n")
        for i in range(0, len(g1), 50):
            f.write(g1[i : i + 50] + "\n")
        f.write(">b\n" + g2 + "\n")
    got = _assert_parse_equal(p)
    assert got.shape == (2, 137)
    assert np.array_equal(cio._parse_python(p.read_bytes(), None), got)


def test_gzip_matches_jax(tmp_path):
    p = tmp_path / "r.fastq.gz"
    with gzip.open(p, "wt") as f:
        for i, r in enumerate(["ACGTACGT", "TTTT", "GGNCA"]):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    got = _assert_parse_equal(p)
    assert np.array_equal(got, pack_reads(["ACGTACGT", "TTTT", "GGNCA"]))
    assert cio.count_fastx_records(str(p)) == 3


def test_crlf_matches_jax(tmp_path):
    p = tmp_path / "crlf.fasta"
    p.write_bytes(b">a\r\nACGT\r\nGG\r\n>b\r\nTT\r\n")
    got = _assert_parse_equal(p)
    assert np.array_equal(got, pack_reads(["ACGTGG", "TT"]))
    q = tmp_path / "crlf.fastq"
    q.write_bytes(b"@a\r\nACGTN\r\n+\r\nIIIII\r\n@b\r\nTT\r\n+\r\nII\r\n")
    assert np.array_equal(_assert_parse_equal(q),
                          pack_reads(["ACGTN", "TT"]))


@pytest.mark.parametrize("length", [1, 4, 10, 12])
def test_fixed_length_truncation_matches_jax(tmp_path, length):
    p = tmp_path / "r.fastq"
    _write_fastq(p, ["ACGTACGTAC", "GG"])
    got = _assert_parse_equal(p, length=length)
    assert np.array_equal(got, pack_reads(["ACGTACGTAC", "GG"], length))


def test_empty_file_matches_jax(tmp_path):
    p = tmp_path / "e.fa"
    p.write_text("")
    assert _assert_parse_equal(p).shape[0] == 0
    assert _assert_parse_equal(p, length=7).shape == (0, 7)
    assert cio.count_fastx_records(str(p)) == 0


def test_multithreaded_matches_single_thread_and_jax(tmp_path):
    rng = np.random.default_rng(3)
    p = tmp_path / "mt.fastq"
    with open(p, "w") as f:
        for i in range(997):
            n = int(rng.integers(5, 151))
            seq = "".join("ACGTN"[j] for j in rng.integers(0, 5, n))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
    a = _assert_parse_equal(p, threads=1)
    b = _assert_parse_equal(p, threads=8)
    assert np.array_equal(a, b)


@pytest.mark.parametrize("lo,hi", [(0, 997), (0, 1), (100, 350), (996, 997),
                                   (500, 500), (-5, 3), (990, 2000),
                                   (2000, 3000), (40, 20)])
def test_record_range_matches_jax(tmp_path, lo, hi):
    rng = np.random.default_rng(4)
    p = tmp_path / "rr.fastq"
    _write_fastq(p, ["".join("ACGTN"[j] for j in rng.integers(
        0, 5, int(rng.integers(5, 120)))) for _ in range(997)])
    full = cio.parse_fastx_codes(str(p))
    got = _assert_parse_equal(p, record_range=(lo, hi), threads=3)
    assert got.shape[1] == full.shape[1]  # L from the whole file
    assert np.array_equal(got, full[max(0, lo) : max(0, hi)])


@pytest.mark.parametrize("text,match", [
    ("hello\n", "not FASTA/FASTQ"), ("@a\nACGT\n+\n", "truncated"),
    ("@a\nACGT\n", "truncated"), ("@a\nAC\n+\nII\n>b\nAC\n", "not FASTA")])
def test_errors_raise_as_jax(tmp_path, text, match):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    for parse in (cio.parse_fastx_codes, jax_cio.parse_fastx_codes,
                  cio.count_fastx_records, jax_cio.count_fastx_records):
        with pytest.raises(ValueError, match=match):
            parse(str(p))


def _codes(seed, B, L, n_rate=0.05):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    return codes


@pytest.mark.parametrize("B,L,n_rate,pad_rows", [
    (1, 1, 0.0, 0), (3, 7, 0.1, 0), (64, 100, 0.0, 0), (257, 104, 0.02, 0),
    (5, 8, 0.5, 0), (33, 37, 0.0, 4), (16, 21, 0.0, 0), (0, 9, 0.0, 0),
    (40, 100, 0.0, 9)])
def test_pack_codes_host_matches_jax(B, L, n_rate, pad_rows):
    """Widths that are not multiples of 4 or 8 (pad columns), and rows of
    code 4 at the end as bench_workload pads its matrices."""
    codes = _codes(B * 1000 + L, B, L, n_rate)
    codes = np.concatenate([codes, np.full((pad_rows, L), 4, np.uint8)])
    want_p, want_i = jax_extract.pack_codes_host(codes)
    packed, invalid, has_invalid = pack_codes_host(codes)
    assert packed.dtype == invalid.dtype == torch.uint8
    assert np.array_equal(packed.numpy(), want_p)
    assert np.array_equal(invalid.numpy(), want_i)
    assert has_invalid == bool((codes >= 4).any())
    plain_p, plain_i = _pack_codes_numpy(codes)
    jp, ji = jax_extract._pack_codes_numpy(codes)
    assert np.array_equal(plain_p, jp) and np.array_equal(plain_i, ji)
    assert np.array_equal(plain_p, want_p) and np.array_equal(plain_i, want_i)


def test_pack_codes_native_takes_views_and_refuses_other_dtypes():
    base = _codes(5, 40, 90)
    view = base[::3, 5:70]  # neither row- nor column-contiguous
    got = cio.pack_codes_native(view, threads=3)
    want = _pack_codes_numpy(np.ascontiguousarray(view))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    with pytest.raises(TypeError, match="uint8"):
        cio.pack_codes_native(base.astype(np.int64))
    with pytest.raises(ValueError, match="contiguous uint8"):
        cio.pack_codes_native(base, out=(np.empty((40, 22), np.uint8),
                                         np.empty((40, 12), np.uint8)))


def _jax_real_keys(codes, k, masked):
    """The JAX packed extractor as its pipeline calls it (rows padded with
    code 4, columns to a multiple of 8), cut to the real windows."""
    B, L = codes.shape
    Lp, Bp = -(-L // 8) * 8, B + 3
    buf = np.full((Bp, Lp), 4, dtype=np.uint8)
    buf[:B, :L] = codes
    packed, invalid = jax_extract._pack_codes_numpy(buf)
    if masked:
        hi, lo = jax_extract.extract_canonical_kmers_packed(
            jnp.asarray(packed), jnp.asarray(invalid), k, Lp)
    else:
        hi, lo = jax_extract.extract_canonical_kmers_packed_nomask(
            jnp.asarray(packed), k, Lp, L, jnp.int32(B))
    if Lp < k:
        return torch.zeros(0, dtype=torch.int64)
    keys = convert.keys_from_pair(np.asarray(hi), np.asarray(lo), "cpu")
    return keys.view(Bp, Lp - k + 1)[:B, : max(L - k + 1, 0)].reshape(-1)


@pytest.mark.parametrize("L", [21, 37, 100])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_packed_extractors_match_jax_and_uint8_path(L, k):
    codes = _codes(L * 100 + k, 23, L)  # N's: the masked path
    assert (codes >= 4).any()
    packed, invalid, has_invalid = pack_codes_host(codes)
    assert has_invalid
    got = extract_canonical_kmers_packed(packed, invalid, k, L)
    want = extract_canonical_kmers(torch.from_numpy(codes), k)
    assert got.numel() == 23 * max(L - k + 1, 0)
    assert torch.equal(got, want)
    assert torch.equal(got, _jax_real_keys(codes, k, masked=True))

    clean = _codes(L * 100 + k + 1, 23, L, n_rate=0.0)  # no N's: no mask
    packed, _, has_invalid = pack_codes_host(clean)
    assert not has_invalid
    got = extract_canonical_kmers_packed(packed, None, k, L)
    assert torch.equal(got, extract_canonical_kmers(torch.from_numpy(clean),
                                                    k))
    assert torch.equal(got, _jax_real_keys(clean, k, masked=False))


@pytest.mark.parametrize("L,k", [(3, 5), (5, 5), (9, 7), (13, 11)])
def test_packed_extractors_at_short_widths(L, k):
    """L < k gives no window; a width one past a multiple of 4 or 8 cuts
    the windows that would reach the pad columns."""
    codes = _codes(L + k, 11, L, n_rate=0.1)
    codes[0, 0] = 4
    packed, invalid, _ = pack_codes_host(codes)
    want = extract_canonical_kmers(torch.from_numpy(codes), k)
    assert want.numel() == 11 * max(L - k + 1, 0)
    assert torch.equal(extract_canonical_kmers_packed(packed, invalid, k, L),
                       want)
    codes[codes >= 4] = 1
    packed, _, _ = pack_codes_host(codes)
    assert torch.equal(extract_canonical_kmers_packed(packed, None, k, L),
                       extract_canonical_kmers(torch.from_numpy(codes), k))


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_native_entry_points_raise_without_the_library(tmp_path, monkeypatch,
                                                       cxx):
    """No silent fallback: with no library every native entry point, the
    code-matrix upload and `--io native` raise."""
    monkeypatch.setattr(cio, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cio, "CXX", cxx)
    p, _ = _fastq(tmp_path)
    assert not cio.native_available()
    codes = _codes(0, 4, 30)
    for call in (lambda: cio.parse_fastx_codes(str(p)),
                 lambda: cio.count_fastx_records(str(p)),
                 lambda: cio.pack_codes_native(codes),
                 lambda: pack_codes_host(codes),
                 lambda: extract_stream(codes, 21, device="cpu"),
                 lambda: cli.main([str(p), "-o", str(tmp_path / "c.fa"),
                                   "--device", "cpu", "--quiet"])):
        with pytest.raises(cio.NativeUnavailable):
            call()
    assert not (tmp_path / "c.fa").exists()
    assert not list((tmp_path / "build").glob("*"))  # no partial build left
