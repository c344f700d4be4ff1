"""Read packing, int64 keys and canonical window extraction in the port
against the JAX package (exact: the same window stream, in order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu.kernels.extract import pack_reads as jax_pack_reads
from genome_tpu.utils import dna as jax_dna
from genome_tpu_torch import convert
from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.assemble.pipeline import extract_stream
from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.extract import (
    extract_canonical_kmers, extract_canonical_kmers_packed,
    extract_canonical_kmers_packed_ref, pack_codes_host, pack_reads)

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _reads(seed, n=40, lo=20, hi=90):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = "".join(rng.choice(list("ACGT"), size=int(rng.integers(lo, hi))))
        if i % 5 == 0:  # N bases and lowercase: invalid windows, no crash
            pos = int(rng.integers(0, len(s)))
            s = s[:pos] + "N" + s[pos + 1 :].lower()
        out.append(s)
    return out


@pytest.mark.parametrize("k", [5, 21, 31])
def test_extract_stream_matches_jax(k):
    reads = _reads(k)
    codes = pack_reads(reads)
    assert np.array_equal(codes, jax_pack_reads(reads))
    jh, jl = jax_extract(jnp.asarray(codes), k)
    got = extract_canonical_kmers(torch.from_numpy(codes), k)
    want = convert.keys_from_pair(np.asarray(jh), np.asarray(jl), "cpu")
    assert torch.equal(got, want)
    assert (got == keys.SENTINEL).any() and (got != keys.SENTINEL).any()


@pytest.mark.parametrize("k", [3, 15, 17, 31])
def test_revcomp_and_canonical_match_host_oracle(k):
    x = np.random.default_rng(k).integers(0, 1 << (2 * k), size=2000,
                                          dtype=np.uint64)
    t = torch.from_numpy(x.astype(np.int64))
    assert np.array_equal(keys.revcomp(t, k).numpy().astype(np.uint64),
                          jax_dna.revcomp_u64(x, k))
    assert np.array_equal(keys.canonical(t, k).numpy().astype(np.uint64),
                          jax_dna.canonical_u64(x, k))


def test_pair_key_round_trip():
    rng = np.random.default_rng(0)
    hi = rng.integers(0, 1 << 30, size=100, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, size=100, dtype=np.uint32)
    hi[:3] = 0xFFFFFFFF
    lo[:3] = [0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF]
    k = convert.keys_from_pair(hi, lo, "cpu")
    assert k[0] == keys.INT64_MAX and k[1] == keys.INT64_MAX - 1
    h2, l2 = convert.pair_from_keys(k)
    assert np.array_equal(h2, hi) and np.array_equal(l2, lo)


def test_extract_stream_strings_equal_code_matrix():
    reads = _reads(7, n=300)
    codes = pack_reads(reads)
    a = extract_stream(reads, 21, device="cpu", batch_reads=64)
    b = extract_stream(codes, 21, device="cpu", chunk_rows=100)
    assert torch.equal(a, b)
    assert extract_stream([], 21, device="cpu").numel() == 0


_jax_extract_jit = jax.jit(jax_extract, static_argnums=1)


def _codes(seed, B, L, n_rate):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < n_rate] = 4
    return codes


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("L_of_k", ["k", "k+1", 37, 100, 101, 150])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_packed_entry_matches_jax_and_uint8_path(k, L_of_k, masked):
    """The single packed entry on the CPU, with the mask (N bases) and
    without it (none), equals the JAX stage and the uint8 path."""
    L = {"k": k, "k+1": k + 1}.get(L_of_k, L_of_k)
    codes = _codes(k * 1000 + L, 13, L, 0.03 if masked else 0.0)
    codes[0, L // 2] = 4 if masked else codes[0, L // 2]
    packed, invalid, has_invalid = pack_codes_host(codes)
    assert has_invalid == masked
    got = extract_canonical_kmers_packed(packed, invalid if masked else None,
                                         k, L)
    want = extract_canonical_kmers(torch.from_numpy(codes), k)
    assert got.numel() == 13 * (L - k + 1)
    assert torch.equal(got, want)
    jh, jl = _jax_extract_jit(jnp.asarray(codes), k)
    assert torch.equal(got, convert.keys_from_pair(np.asarray(jh),
                                                   np.asarray(jl), "cpu"))
    assert (got == keys.SENTINEL).any() == masked


@pytest.mark.parametrize("chunk_rows", [1, 7, 29, 30, 31, 64])
@pytest.mark.parametrize("n_rate", [0.0, 0.02])
def test_extract_stream_rows_not_a_multiple_of_chunk_rows(chunk_rows, n_rate):
    """A last chunk shorter than the others (or the only one) lands in
    its own slice of the stream; chunks with and without N's mix."""
    codes = _codes(chunk_rows, 30, 101, n_rate)
    got = extract_stream(codes, 21, device="cpu", chunk_rows=chunk_rows)
    assert torch.equal(got, extract_canonical_kmers(torch.from_numpy(codes),
                                                    21))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rows", [(5, 5, 5), (1, 9, 4), (8, 0, 3)])
def test_out_slices_equal_the_cat_of_parts(rows, masked):
    """Writing each chunk into its slice of one stream gives the same
    stream as concatenating each chunk's own keys."""
    k, L = 21, 60
    codes = _codes(sum(rows) + masked, sum(rows), L, 0.05 if masked else 0.0)
    nwin = L - k + 1
    stream = torch.full((sum(rows) * nwin,), -1, dtype=torch.int64)
    parts, at = [], 0
    for n in rows:
        packed, invalid, _ = pack_codes_host(codes[at : at + n])
        inv = invalid if masked else None
        parts.append(extract_canonical_kmers_packed(packed, inv, k, L))
        got = extract_canonical_kmers_packed(
            packed, inv, k, L, out=stream[at * nwin : (at + n) * nwin])
        assert got.data_ptr() == stream[at * nwin :].data_ptr() or n == 0
        at += n
    assert torch.equal(stream, torch.cat(parts))


@pytest.mark.parametrize("batch_reads", [1, 64, 299, 300, 1000])
@pytest.mark.parametrize("k", [15, 31])
def test_string_path_equals_code_matrix_path(k, batch_reads):
    reads = _reads(k + batch_reads, n=300)
    codes = pack_reads(reads)
    assert torch.equal(
        extract_stream(reads, k, device="cpu", batch_reads=batch_reads),
        extract_stream(codes, k, device="cpu", chunk_rows=128))


@pytest.mark.parametrize("case", ["dtype", "width", "mask_width", "k",
                                  "out_size", "out_dtype", "device"])
def test_packed_entry_refuses_what_it_does_not_take(case):
    packed, invalid, _ = pack_codes_host(_codes(0, 4, 30, 0.1))
    args = dict(packed=packed, invalid=invalid, k=21, L=30, out=None)
    args.update({
        "dtype": dict(packed=packed.to(torch.int32)),
        "width": dict(L=34),
        "mask_width": dict(invalid=invalid[:, :3].contiguous()),
        "k": dict(k=33),
        "out_size": dict(out=torch.empty(39, dtype=torch.int64)),
        "out_dtype": dict(out=torch.empty(40, dtype=torch.int32)),
        "device": dict(packed=packed.to("meta"),
                       invalid=invalid.to("meta"))}[case])
    with pytest.raises(ValueError):
        extract_canonical_kmers_packed(**args)


def test_count_phase_counts_extract_chunks():
    """Each chunk or batch of strings through the packed entry adds one
    to the phase's `extract_chunks`."""
    codes = _codes(3, 50, 80, 0.01)
    m = Metrics(quiet=True)
    with m.phase("count"):
        a = extract_stream(codes, 21, device="cpu", chunk_rows=16)
    with m.phase("count"):
        b = extract_stream(pack_reads(["ACGT" * 10] * 3), 21, device="cpu")
    with m.phase("count"):
        c = extract_stream(["ACGT" * 10] * 5, 21, device="cpu",
                           batch_reads=2)
    ends = [e for e in m.events if e["event"] == "phase_end"]
    assert [e.get("extract_chunks") for e in ends] == [4, 1, 3]
    assert torch.equal(a, extract_canonical_kmers_packed_ref(
        *pack_codes_host(codes)[:2], 21, 80))
    assert b.numel() == 3 * 20
    assert torch.equal(c, b[:20].repeat(5))
