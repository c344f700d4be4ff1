"""The bitonic block sort, block merge and global merge sort of the port
against the JAX package's Pallas kernels run in interpret mode, exactly:
every output array, payload order among equal keys included."""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.kernels import bitonic as jbitonic
from genome_tpu.kernels.mergesort import sort_pairs_merge as jax_merge_sort
from genome_tpu_torch import convert
from genome_tpu_torch.kernels import bitonic, mergesort

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _case(seed, n, key_hi, num_keys):
    """num_keys uint32 key arrays below 2^31 (key_hi values: many ties)
    and a uint32 payload naming each slot."""
    rng = np.random.default_rng(seed)
    keys = [rng.integers(0, key_hi, n, dtype=np.uint32)
            for _ in range(num_keys)]
    return keys + [np.arange(n, dtype=np.uint32)[::-1].copy()]


def _jax(fn, arrays, num_keys, block):
    return [np.asarray(a) for a in fn(tuple(jnp.asarray(a) for a in arrays),
                                      num_keys, block, interpret=True)]


def _bitonic_runs(seed, block, nb):
    """nb runs, each ascending then descending: merge_blocks input."""
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(nb):
        h = np.sort(rng.integers(0, 40, block, dtype=np.uint32))
        runs.append(np.concatenate([h[: block // 2], h[block // 2:][::-1]]))
    return np.concatenate(runs)


# Each JAX call shape costs a 2-3 s interpret-mode compile, so the cases
# share shapes; block 512 runs in the merge test below and, through
# sort_pairs_merge, in tests/test_torch_count.py.
@pytest.mark.parametrize("num_keys,block,n,key_hi", [
    (1, 256, 1024, 16),        # heavy ties, 4 blocks
    (1, 256, 1024, 1 << 31),   # full-range int32 keys
    (2, 256, 1024, 4),         # two keys with ties in both
])
def test_sort_blocks_matches_jax(num_keys, block, n, key_hi):
    arrays = _case(block + n, n, key_hi, num_keys)
    want = _jax(jbitonic.sort_blocks, arrays, num_keys, block)
    got = bitonic.sort_blocks(
        tuple(torch.from_numpy(a.astype(np.int32)) for a in arrays),
        num_keys, block)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(np.int32))


def test_sort_blocks_pair_as_one_int64_key_matches_jax():
    """The (hi, lo) pair as one int64 key with an int64 payload gives the
    two-key JAX network's output, payload order included (the two-key
    case's shape above, so the JAX call reuses its compile)."""
    hi, lo, pay = _case(5, 1024, 3, 2)
    want = _jax(jbitonic.sort_blocks, (hi, lo, pay), 2, 256)
    got_k, got_p = bitonic.sort_blocks(
        (convert.keys_from_pair(hi, lo, "cpu"),
         torch.from_numpy(pay.astype(np.int64))), 1, 256)
    gh, gl = convert.pair_from_keys(got_k)
    assert np.array_equal(gh, want[0]) and np.array_equal(gl, want[1])
    assert np.array_equal(got_p.numpy(), want[2].astype(np.int64))


@pytest.mark.parametrize("block,nb", [(256, 3), (512, 2)])
def test_merge_blocks_matches_jax(block, nb):
    keys = _bitonic_runs(block, block, nb)
    pay = np.arange(keys.size, dtype=np.uint32)
    want = _jax(jbitonic.merge_blocks, (keys, pay), 1, block)
    got = bitonic.merge_blocks((torch.from_numpy(keys.astype(np.int32)),
                                torch.from_numpy(pay.astype(np.int32))),
                               1, block)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w.astype(np.int32))
    # each run came out sorted
    assert (np.diff(got[0].numpy().reshape(nb, block), axis=1) >= 0).all()


@pytest.mark.parametrize("nblocks", [1, 3, 5])
def test_sort_pairs_merge_matches_jax(nblocks):
    rng = np.random.default_rng(nblocks)
    block = 256
    n = nblocks * block
    hi = rng.integers(0, 1 << 10, n, dtype=np.uint32)
    lo = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    hi[::7] = lo[::7] = 0xFFFFFFFF  # sentinel rows
    jh, jl = jax_merge_sort(jnp.asarray(hi), jnp.asarray(lo), block=block,
                            interpret=True)
    got = mergesort.sort_pairs_merge(convert.keys_from_pair(hi, lo, "cpu"),
                                     block=block)
    gh, gl = convert.pair_from_keys(got)
    assert np.array_equal(gh, np.asarray(jh))
    assert np.array_equal(gl, np.asarray(jl))


@pytest.mark.parametrize("call", [
    partial(bitonic.sort_blocks, num_keys=1, block=384),   # not a power of 2
    partial(bitonic.sort_blocks, num_keys=1, block=128),   # below 256
    partial(bitonic.merge_blocks, num_keys=1, block=1024),  # n % block != 0
    partial(bitonic.sort_blocks, num_keys=3, block=256),   # num_keys > 2
])
def test_invalid_arguments_raise(call):
    with pytest.raises(ValueError):
        call((torch.zeros(768, dtype=torch.int64),))
    with pytest.raises(ValueError):
        mergesort.sort_pairs_merge(torch.zeros(300, dtype=torch.int64), 256)
