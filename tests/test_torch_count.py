"""k-mer counting in the port against the JAX package: table, counts,
n_unique and overflow, exactly; also count_weighted, merge_tables,
filter_table and the merge-sort sorter hook, fed through
genome_tpu_torch.convert."""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.kernels import count as jcount
from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu.kernels.mergesort import sort_pairs_merge as jax_merge_sort
from genome_tpu_torch import convert
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels import count
from genome_tpu_torch.kernels.mergesort import sort_pairs_merge
from genome_tpu_torch.kernels.extract import pack_reads

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _stream(seed=1, glen=1500, err=0.02, k=21):
    reads = simulate_reads(random_genome(glen, seed=seed), read_len=70,
                           coverage=12, error_rate=err, seed=seed + 1)
    jh, jl = jax_extract(jnp.asarray(pack_reads(reads)), k)
    return np.asarray(jh), np.asarray(jl)


def _assert_table_equal(port, jax_res):
    want = convert.table_from_jax(jax_res, "cpu")
    assert int(port["n_unique"]) == int(want["n_unique"])
    assert bool(port["overflow"]) == bool(want["overflow"])
    assert torch.equal(port["table"], want["table"])
    assert torch.equal(port["counts"], want["counts"])


@pytest.mark.parametrize("min_cov,cap", [(1, 1 << 15), (2, 1 << 15),
                                         (3, 1 << 15), (2, 1 << 11)])
def test_count_matches_jax(min_cov, cap):
    jh, jl = _stream()
    want = jcount.count_kmers_device(jnp.asarray(jh), jnp.asarray(jl),
                                     min_cov, cap)
    got = count.count_kmers_device(convert.keys_from_pair(jh, jl, "cpu"),
                                   min_cov, cap)
    _assert_table_equal(got, want)
    assert bool(got["overflow"]) == (cap == 1 << 11)


def test_count_weighted_matches_jax():
    jh, jl = _stream(seed=4)
    w = np.random.default_rng(0).integers(1, 5, size=jh.size).astype(np.uint32)
    want = jcount.count_weighted(jnp.asarray(jh), jnp.asarray(jl),
                                 jnp.asarray(w), 3, 1 << 15)
    got = count.count_weighted(convert.keys_from_pair(jh, jl, "cpu"),
                               torch.from_numpy(w.astype(np.int32)), 3,
                               1 << 15)
    _assert_table_equal(got, want)


def test_merge_and_filter_tables_match_jax():
    jh, jl = _stream(seed=7)
    half = jh.size // 2
    cap = 1 << 15
    ja = jcount.count_kmers_device(jnp.asarray(jh[:half]),
                                   jnp.asarray(jl[:half]), 1, cap)
    jb = jcount.count_kmers_device(jnp.asarray(jh[half:]),
                                   jnp.asarray(jl[half:]), 1, cap)
    jm = jcount.merge_tables(ja, jb, 1, cap)
    jf = jcount.filter_table(jm, 2)
    # the port merges the JAX stage's partial tables
    pm = count.merge_tables(convert.table_from_jax(ja, "cpu"),
                            convert.table_from_jax(jb, "cpu"), 1, cap)
    _assert_table_equal(pm, jm)
    _assert_table_equal(count.filter_table(pm, 2), jf)
    # and the merged, filtered table equals one-shot counting
    one = count.count_kmers_device(convert.keys_from_pair(jh, jl, "cpu"), 2,
                                   cap)
    assert torch.equal(one["table"], count.filter_table(pm, 2)["table"])


def test_count_with_merge_sorter_matches_jax():
    jh, jl = _stream(seed=3, glen=500)
    pad = np.full(-jh.size % 512, 0xFFFFFFFF, np.uint32)
    jh, jl = np.concatenate([jh, pad]), np.concatenate([jl, pad])
    want = jcount.count_kmers_device(
        jnp.asarray(jh), jnp.asarray(jl), 2, 1 << 13,
        sorter=partial(jax_merge_sort, block=512, interpret=True))
    got = count.count_kmers_device(convert.keys_from_pair(jh, jl, "cpu"), 2,
                                   1 << 13,
                                   sorter=partial(sort_pairs_merge, block=512))
    _assert_table_equal(got, want)
    assert int(got["n_unique"]) > 0


def test_count_empty_stream():
    got = count.count_kmers_device(torch.zeros(0, dtype=torch.int64), 2, 64)
    assert int(got["n_unique"]) == 0 and not bool(got["overflow"])
    assert got["table"].shape == (64,)
