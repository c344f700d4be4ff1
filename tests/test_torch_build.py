"""Graph build in the port (build_graph_kjoin and the oracles
build_graph_bsearch and build_graph_join, with searchsorted_pair) against
the JAX package's: succ and okv exactly, on tables from the golden counter
and from the JAX count stage (carried across with
genome_tpu_torch.convert); each oracle also equals build_graph_kjoin."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.graph import build as jbuild
from genome_tpu.graph.build import build_graph_kjoin as jax_build
from genome_tpu.kernels import u64
from genome_tpu.kernels.count import count_kmers_device as jax_count
from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu_torch import convert
from genome_tpu_torch.graph import build as pbuild
from genome_tpu_torch.graph.build import build_graph_kjoin
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels.extract import pack_reads

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _reads(seed, glen=1200):
    return simulate_reads(random_genome(glen, seed=seed), read_len=60,
                          coverage=15, error_rate=0.01, seed=seed + 1)


def _assert_graph_equal(got, want):
    succ, okv = got
    ws, wokv = convert.graph_from_jax(*map(np.asarray, want), device="cpu")
    assert torch.equal(succ, ws)
    assert torch.equal(okv, wokv)


@pytest.mark.parametrize("k", [5, 13, 21, 31])
def test_build_matches_jax_on_golden_table(k):
    kmers, _ = count_canonical_kmers(_reads(k), k, 2)
    cap = kmers.size + 37  # slack slots beyond n_unique
    th = np.zeros(cap, np.uint32)
    tl = np.zeros(cap, np.uint32)
    th[: kmers.size], tl[: kmers.size] = u64.from_u64_np(kmers)
    want = jax_build(jnp.asarray(th), jnp.asarray(tl), jnp.int32(kmers.size),
                     k)
    got = build_graph_kjoin(convert.keys_from_pair(th, tl, "cpu"),
                            kmers.size, k)
    _assert_graph_equal(got, want)
    assert (got[0] >= 0).any(), "fixture must have edges"


def _golden_table(k, slack=37):
    kmers, _ = count_canonical_kmers(_reads(k), k, 2)
    th = np.zeros(kmers.size + slack, np.uint32)
    tl = np.zeros(kmers.size + slack, np.uint32)
    th[: kmers.size], tl[: kmers.size] = u64.from_u64_np(kmers)
    return kmers, th, tl


@pytest.mark.parametrize("name", ["build_graph_bsearch", "build_graph_join"])
@pytest.mark.parametrize("k", [5, 21, 31])
def test_oracle_builds_match_jax_and_kjoin(name, k):
    kmers, th, tl = _golden_table(k)
    want = getattr(jbuild, name)(jnp.asarray(th), jnp.asarray(tl),
                                 jnp.int32(kmers.size), k)
    table = convert.keys_from_pair(th, tl, "cpu")
    got = getattr(pbuild, name)(table, kmers.size, k)
    _assert_graph_equal(got, want)
    kj = build_graph_kjoin(table, kmers.size, k)
    assert torch.equal(got[0], kj[0]) and torch.equal(got[1], kj[1])
    assert pbuild.build_graph_device is build_graph_kjoin


@pytest.mark.parametrize("slack", ["sentinel", "zero"])
def test_searchsorted_pair_matches_jax(slack):
    """Queries below, between, on and above the table's valid prefix: the
    lower bound in the valid prefix (0..n_valid). With the count stage's
    sentinel slots past n_valid it equals JAX's. With zeros there, JAX's
    loop, which runs on after it converges, reads slot n_valid and gives
    n_valid + 1 for a query above the table (a fault of the reference's
    own contract, "entries at index >= n_valid are treated as +inf"); the
    port keeps the contract."""
    kmers, th, tl = _golden_table(13)
    fill = 0xFFFFFFFF if slack == "sentinel" else 0
    th[kmers.size:], tl[kmers.size:] = fill, fill
    rng = np.random.default_rng(4)
    q = np.concatenate([kmers[rng.integers(0, kmers.size, 64)],
                        rng.integers(0, 1 << 26, 64).astype(np.uint64),
                        np.array([0, kmers[-1] + 1, (1 << 26) - 1],
                                 np.uint64)])
    qh, ql = u64.from_u64_np(q)
    want = np.asarray(jbuild.searchsorted_pair(
        jnp.asarray(th), jnp.asarray(tl), jnp.int32(kmers.size),
        jnp.asarray(qh), jnp.asarray(ql)))
    got = pbuild.searchsorted_pair(convert.keys_from_pair(th, tl, "cpu"),
                                   kmers.size,
                                   torch.from_numpy(q.astype(np.int64)))
    assert got.dtype == torch.int32
    got = got.numpy()
    assert np.array_equal(got, np.searchsorted(kmers, q))
    above = q > kmers[-1]
    assert above.sum() > 2
    if slack == "zero":
        assert (want[above] == kmers.size + 1).all()
        got[above] += 1
    assert np.array_equal(got, want)


def test_build_on_jax_count_stage_output():
    k = 21
    jh, jl = jax_extract(jnp.asarray(pack_reads(_reads(3, glen=2000))), k)
    res = jax_count(jh, jl, 2, 1 << 14)
    want = jax_build(res["table_hi"], res["table_lo"], res["n_unique"], k)
    table = convert.table_from_jax(res, "cpu")
    got = build_graph_kjoin(table["table"], table["n_unique"], k)
    _assert_graph_equal(got, want)
