"""B-way stable partition in the port (genome_tpu_torch.kernels.partition)
against the JAX package's Pallas kernel (interpret mode, as its own tests
run it): the cases of tests/test_partition.py, plus out-of-range bids and
payloads of both widths. totals, overflow and every out[b, :totals[b]] are
compared exactly; the output only where nothing overflows, as JAX's test
does. The CUDA kernels themselves are held against the plain version in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.kernels.partition import CHUNK as JAX_CHUNK
from genome_tpu.kernels.partition import partition_by_bucket as jax_partition
from genome_tpu_torch.kernels import partition
from genome_tpu_torch.kernels.partition import CHUNK

from tests.torch_cpu import one_torch_thread  # noqa: F401

ROW = 2048  # small row_len keeps interpret mode fast; % CHUNK == 0


def _bids(rng, n, B, skew=None, lo=0):
    if skew is not None:
        return rng.choice(B, size=n, p=skew).astype(np.int32)
    return rng.integers(lo, B, size=n, dtype=np.int32)


def _check(bid, rem, B, cap, rem_dtype, expect_ovf=False):
    """The port on (bid, rem as rem_dtype) against JAX on (bid, rem)."""
    jout, jtot, jovf = jax_partition(jnp.asarray(bid), jnp.asarray(rem), B,
                                     cap, row_len=ROW, interpret=True)
    out, totals, ovf = partition.partition_by_bucket(
        torch.from_numpy(bid), torch.from_numpy(rem.astype(rem_dtype)), B,
        cap)
    assert bool(ovf) == bool(jovf) == expect_ovf
    jtot = np.asarray(jtot)
    assert np.array_equal(totals.numpy(), jtot)
    jout = np.asarray(jout).astype(rem_dtype)
    for b in range(B):
        m = int(jtot[b])
        if not expect_ovf:
            assert np.array_equal(out[b, :m].numpy(), jout[b, :m]), b
    return out, totals


@pytest.mark.parametrize("name,seed,R,B,cap_chunks,skew,rem_dtype", [
    ("single row", 0, 1, 8, 2, None, np.int32),
    # per-bucket per-row loads ~ROW/B: carries spliced across rows
    ("multirow carry splice", 1, 6, 8, 4, None, np.int64),
    ("skewed chunk boundaries", 2, 5, 8, 8, "hot3", np.int32),
])
def test_partition_matches_pallas(name, seed, R, B, cap_chunks, skew,
                                  rem_dtype):
    rng = np.random.default_rng(seed)
    if skew == "hot3":  # one hot bucket over many chunks, one near-empty
        skew = np.full(8, 0.3 / 6)
        skew[3], skew[5] = 0.65, 0.05
    bid = _bids(rng, R * ROW, B, skew)
    rem = rng.integers(0, 1 << 31, size=R * ROW, dtype=np.uint32)
    _check(bid, rem, B, cap_chunks * CHUNK, rem_dtype)


def test_partition_all_one_bucket_matches_pallas():
    bid = np.zeros(2 * ROW, np.int32)
    rem = np.arange(2 * ROW, dtype=np.uint32)
    cap = ((2 * ROW) // CHUNK + 1) * CHUNK
    out, totals = _check(bid, rem, 4, cap, np.int32)
    assert totals.tolist() == [2 * ROW, 0, 0, 0]
    assert np.array_equal(out[0, :2 * ROW].numpy(), rem.astype(np.int32))


def test_partition_overflow_flag_matches_pallas():
    # the hot bucket exceeds bucket_cap - CHUNK: flagged, totals exact
    rng = np.random.default_rng(3)
    skew = np.full(4, 0.1 / 3)
    skew[0] = 0.9
    bid = _bids(rng, 4 * ROW, 4, skew)
    rem = rng.integers(0, 1 << 31, size=4 * ROW, dtype=np.uint32)
    out, totals = _check(bid, rem, 4, 2 * CHUNK, np.int32, expect_ovf=True)
    # the port writes every rank below the cap, in stream order
    assert np.array_equal(out[0].numpy(), rem[bid == 0][:2 * CHUNK])


def test_partition_drops_out_of_range_bids_as_pallas():
    # bids in -2..5 with B = 4: negative and >= B are in no bucket
    rng = np.random.default_rng(4)
    bid = _bids(rng, 3 * ROW, 6, lo=-2)
    rem = rng.integers(0, 1 << 31, size=3 * ROW, dtype=np.uint32)
    _, totals = _check(bid, rem, 4, 4 * CHUNK, np.int32)
    assert int(totals.sum()) == int(((bid >= 0) & (bid < 4)).sum())


def test_partition_int64_payload_moves_full_uint32_range():
    # JAX's uint32 payloads carried as int64, top bit set on about half
    rng = np.random.default_rng(5)
    bid = _bids(rng, 2 * ROW, 8)
    rem = rng.integers(0, 1 << 32, size=2 * ROW, dtype=np.uint64) \
        .astype(np.uint32)
    _check(bid, rem, 8, 2 * CHUNK, np.int64)


def test_partition_chunk_matches_jax():
    assert CHUNK == JAX_CHUNK


def test_partition_int64_bids_and_empty_stream():
    partition.reset_launches()
    bid = torch.tensor([3, 0, 3, -7, 1 << 40, 0], dtype=torch.int64)
    rem = torch.tensor([-1, 2, 3, 4, 5, 6], dtype=torch.int64)
    out, totals, ovf = partition.partition_by_bucket(bid, rem, 4, CHUNK)
    assert totals.tolist() == [2, 0, 0, 2] and bool(ovf)
    assert out[0, :2].tolist() == [2, 6] and out[3, :2].tolist() == [-1, 3]
    out, totals, ovf = partition.partition_by_bucket(
        bid[:0], rem[:0], 2, CHUNK)
    assert out.shape == (2, CHUNK) and totals.tolist() == [0, 0]
    assert not bool(ovf)
    assert sum(partition.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["cap", "cap0", "dtype", "length", "B0",
                                 "Bmax"])
def test_partition_rejects_bad_inputs(bad):
    bid = torch.zeros(8, dtype=torch.int32)
    rem = torch.arange(8)
    B, cap = 2, CHUNK
    if bad == "cap":
        cap = CHUNK + 8
    elif bad == "cap0":
        cap = 0
    elif bad == "dtype":
        rem = rem.float()
    elif bad == "length":
        rem = rem[:7]
    elif bad == "B0":
        B = 0
    else:
        B = partition.MAX_BUCKETS + 1
    with pytest.raises(ValueError):
        partition.partition_by_bucket(bid, rem, B, cap)
