"""Read packing, int64 keys and canonical window extraction in the port
against the JAX package (exact: the same window stream, in order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu.kernels.extract import pack_reads as jax_pack_reads
from genome_tpu.utils import dna as jax_dna
from genome_tpu_torch import convert
from genome_tpu_torch.assemble.pipeline import extract_stream
from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.extract import (extract_canonical_kmers,
                                              pack_reads)

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
