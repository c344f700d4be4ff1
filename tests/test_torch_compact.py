"""Stream compaction in the port (genome_tpu_torch.kernels.compact) against
the JAX package's Pallas kernel (interpret mode, as its own tests run it)
and its compact_ids. All comparisons are exact (integer outputs). The
CUDA kernel itself is held against the plain version in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.kernels.compact import CHUNK, TILE
from genome_tpu.kernels.compact import compact_flagged as jax_compact
from genome_tpu.kernels.compact import compact_ids as jax_compact_ids
from genome_tpu_torch.kernels import compact

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _flags_with_counts(rng, flag_counts):
    n = len(flag_counts) * TILE
    flags = np.zeros(n, bool)
    for t, c in enumerate(flag_counts):
        flags[rng.choice(TILE, size=c, replace=False) + t * TILE] = True
    return flags


def _check_against_jax(flags, cap_port):
    rng = np.random.default_rng(int(flags.sum()) + flags.size)
    n = flags.size
    a = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    b = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    total = int(flags.sum())
    cap_jax = (total // CHUNK + 2) * CHUNK
    (ja, jb), jpos, jtot, jovf = jax_compact(
        jnp.asarray(flags), (jnp.asarray(a), jnp.asarray(b)), cap_jax,
        interpret=True)
    ta = torch.from_numpy(a.astype(np.int64))
    tb = torch.from_numpy(b.astype(np.int32))  # values < 2^31
    (pa, pb), ppos, ptot, povf = compact.compact_flagged(
        torch.from_numpy(flags), (ta, tb), cap_port)
    assert int(ptot) == int(jtot) == total
    assert bool(povf) == (total > cap_port) and not bool(jovf)
    m = min(total, cap_port)
    assert np.array_equal(ppos[:m].numpy(), np.asarray(jpos)[:m])
    assert np.array_equal(pa[:m].numpy(), np.asarray(ja)[:m].astype(np.int64))
    assert np.array_equal(pb[:m].numpy(), np.asarray(jb)[:m].astype(np.int32))


@pytest.mark.parametrize("p", [0.0, 0.07, 1.0])
def test_compact_random_matches_pallas(p):
    flags = np.random.default_rng(int(p * 100) + 2).random(TILE) < p
    _check_against_jax(flags, TILE)


@pytest.mark.parametrize("counts", [(1009, 2027, 4093, CHUNK + 1),
                                    (0, 1, TILE, 2048)])
def test_compact_multitile_carry_matches_pallas(counts):
    flags = _flags_with_counts(np.random.default_rng(3), counts)
    _check_against_jax(flags, flags.size)


def test_compact_overflow_keeps_exact_total_and_prefix():
    # total spills past capacity: the total stays exact, the prefix is the
    # Pallas kernel's (whose overflow margin is one chunk wider)
    n = 3 * TILE
    flags = np.ones(n, bool)
    a = np.arange(n, dtype=np.uint32)
    cap = 4 * CHUNK
    (ja,), jpos, jtot, jovf = jax_compact(
        jnp.asarray(flags), (jnp.asarray(a),), cap, interpret=True)
    (pa,), ppos, ptot, povf = compact.compact_flagged(
        torch.from_numpy(flags), (torch.from_numpy(a.astype(np.int64)),), cap)
    assert bool(jovf) and bool(povf) and int(ptot) == int(jtot) == n
    m = cap - CHUNK
    assert np.array_equal(pa[:m].numpy(), np.asarray(ja)[:m])
    assert np.array_equal(ppos[:cap].numpy(), np.arange(cap))


@pytest.mark.parametrize("n,p,M", [(5000, 0.3, 4096), (5000, 0.3, 512),
                                   (777, 0.0, 64), (777, 1.0, 1024)])
def test_compact_ids_matches_jax(n, p, M):
    flags = np.random.default_rng(n + M).random(n) < p
    jids, jn, jovf = jax_compact_ids(jnp.asarray(flags), M)
    pids, pn, povf = compact.compact_ids(torch.from_numpy(flags), M)
    assert int(pn) == int(jn) and bool(povf) == bool(jovf)
    m = min(int(jn), M)
    assert np.array_equal(pids[:m].numpy(), np.asarray(jids)[:m])


def test_compact_cpu_runs_plain_version_without_launch():
    compact.reset_launches()
    flags = torch.tensor([True, False, True])
    outs, pos, total, ovf = compact.compact_flagged(
        flags, (torch.tensor([5, 6, 7]),), 4, site="count_heads")
    assert pos[:2].tolist() == [0, 2] and outs[0][:2].tolist() == [5, 7]
    assert int(total) == 2 and not bool(ovf)
    assert sum(compact.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "length", "flags", "count"])
def test_compact_rejects_bad_inputs(bad):
    flags = torch.ones(8, dtype=torch.bool)
    arrays = (torch.arange(8),)
    if bad == "dtype":
        arrays = (torch.arange(8, dtype=torch.float32),)
    elif bad == "length":
        arrays = (torch.arange(7),)
    elif bad == "flags":
        flags = torch.ones(8, dtype=torch.int32)
    else:
        arrays = (torch.arange(8),) * (compact.MAX_ARRAYS + 1)
    with pytest.raises(ValueError):
        compact.compact_flagged(flags, arrays, 8)
