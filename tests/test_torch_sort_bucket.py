"""The port's alternative counters against the JAX package, exactly: the
bucket-partition sort (keys position by position, overflow flag, the
(key, w) multiset of every bucket region), the bucket and hash-table
count tables, and the fmix32 owner hash."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.dist.partition import _fmix32_jnp
from genome_tpu.kernels import extract_canonical_kmers, pack_reads
from genome_tpu.kernels.hash_table import (
    count_kmers_hashtable as jax_count_hashtable)
from genome_tpu.kernels.sort_bucket import (
    bucket_partition_sort as jax_bucket_sort)
from genome_tpu.kernels.sort_bucket import count_kmers_bucket as jax_bucket
from genome_tpu_torch import convert
from genome_tpu_torch.kernels.keys import fmix32
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels.hash_table import count_kmers_hashtable
from genome_tpu_torch.kernels.sort_bucket import (bucket_partition_sort,
                                                  count_kmers_bucket)

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _stream(k=21, seed=19, glen=1200):
    reads = simulate_reads(random_genome(glen, seed=seed), read_len=80,
                           coverage=8, error_rate=0.02, seed=seed + 1)
    reads[0] = reads[0][:10] + "N" + reads[0][11:]  # sentinel windows
    hi, lo = extract_canonical_kmers(pack_reads(reads), k)
    return np.asarray(hi), np.asarray(lo)


def _table_equal(port, jax_res):
    want = convert.table_from_jax(jax_res, "cpu")
    assert int(port["n_unique"]) == int(want["n_unique"]) > 0
    assert bool(port["overflow"]) == bool(want["overflow"])
    assert torch.equal(port["table"], want["table"])
    assert torch.equal(port["counts"], want["counts"])


@pytest.mark.parametrize("k,row,bits,seg", [
    (21, 512, 6, 0), (15, 256, 4, 0), (31, 512, 8, 0),
    (21, 256, 2, 256)])  # the last overflows its regions
def test_bucket_partition_sort_matches_jax(k, row, bits, seg):
    hi, lo = _stream(k=k)
    w = np.random.default_rng(k).integers(1, 6, hi.size).astype(np.uint32)
    jh, jl, jw, jovf = map(np.asarray, jax_bucket_sort(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w), k,
        bucket_bits=bits, row=row, seg=seg))
    gk, gw, govf = bucket_partition_sort(
        convert.keys_from_pair(hi, lo, "cpu"),
        torch.from_numpy(w.astype(np.int32)), k, bucket_bits=bits, row=row,
        seg=seg)
    assert bool(govf) == bool(jovf) == (seg != 0)
    assert torch.equal(gk, convert.keys_from_pair(jh, jl, "cpu"))
    # equal keys may carry their weights in another order: compare the
    # (key, w) multiset region by region
    nb = 1 << bits
    want = np.stack([convert.keys_from_pair(jh, jl, "cpu").numpy(),
                     jw.astype(np.int64)], 1).reshape(nb, -1, 2)
    got = np.stack([gk.numpy(), gw.numpy().astype(np.int64)],
                   1).reshape(nb, -1, 2)
    for b in range(nb):
        assert np.array_equal(np.unique(got[b], axis=0, return_counts=True)[1],
                              np.unique(want[b], axis=0,
                                        return_counts=True)[1])
        assert np.array_equal(np.unique(got[b], axis=0),
                              np.unique(want[b], axis=0))


@pytest.mark.parametrize("min_cov", [1, 2])
def test_count_bucket_and_hashtable_match_jax(min_cov):
    hi, lo = _stream()
    keys = convert.keys_from_pair(hi, lo, "cpu")
    jhi, jlo = jnp.asarray(hi), jnp.asarray(lo)
    _table_equal(count_kmers_bucket(keys, min_cov, 8192, k=21, bucket_bits=8,
                                    row=512),
                 jax_bucket(jhi, jlo, min_cov, capacity=8192, k=21,
                            bucket_bits=8, row=512))
    _table_equal(count_kmers_hashtable(keys, min_cov, 8192),
                 jax_count_hashtable(jhi, jlo, min_cov, capacity=8192))


def test_hashtable_overflow_matches_jax():
    hi, lo = _stream(glen=600)
    got = count_kmers_hashtable(convert.keys_from_pair(hi, lo, "cpu"), 1, 256,
                                max_rounds=8)
    want = jax_count_hashtable(jnp.asarray(hi), jnp.asarray(lo), 1,
                               capacity=256, max_rounds=8)
    assert bool(got["overflow"]) and bool(want["overflow"])
    _table_equal(got, want)


def test_fmix32_matches_jax():
    x = np.array([0, 1, 0xFFFFFFFF, 0x80000000, 0xFFFF0000, 0x0000FFFF,
                  0xDEADBEEF, 0x85EBCA6B, 0xC2B2AE35, 0x7FFFFFFF],
                 dtype=np.uint32)
    x = np.concatenate([x, np.random.default_rng(0).integers(
        0, 1 << 32, 1000, dtype=np.uint32)])
    want = np.asarray(_fmix32_jnp(jnp.asarray(x)))
    got = fmix32(torch.from_numpy(x.astype(np.int64)))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_empty_and_all_sentinel_streams():
    z = torch.zeros(0, dtype=torch.int64)
    for res in (count_kmers_bucket(z, 1, 64, k=21),
                count_kmers_hashtable(z, 1, 64),
                count_kmers_bucket(torch.full((1024,), (1 << 63) - 1), 1, 64,
                                   k=21, row=256)):
        assert int(res["n_unique"]) == 0 and not bool(res["overflow"])
    with pytest.raises(ValueError):
        count_kmers_hashtable(z, 1, 96)
