"""Graph build in the port (build_graph_kjoin) against the JAX package's:
succ and okv exactly, on tables from the golden counter and from the JAX
count stage (carried across with genome_tpu_torch.convert)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.graph.build import build_graph_kjoin as jax_build
from genome_tpu.kernels import u64
from genome_tpu.kernels.count import count_kmers_device as jax_count
from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu_torch import convert
from genome_tpu_torch.graph.build import build_graph_kjoin
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels.extract import pack_reads


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


def test_build_on_jax_count_stage_output():
    k = 21
    jh, jl = jax_extract(jnp.asarray(pack_reads(_reads(3, glen=2000))), k)
    res = jax_count(jh, jl, 2, 1 << 14)
    want = jax_build(res["table_hi"], res["table_lo"], res["n_unique"], k)
    table = convert.table_from_jax(res, "cpu")
    got = build_graph_kjoin(table["table"], table["n_unique"], k)
    _assert_graph_equal(got, want)
