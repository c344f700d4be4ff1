"""Digit histogram in the port (genome_tpu_torch.kernels.hist) against the
JAX package's Pallas kernel (interpret mode, as its own tests run it), on
the same keys converted with keys_from_pair_np: sentinel and
near-sentinel pairs included, so the digits that cover bit 63 are held to
JAX's bins. All comparisons are exact. The CUDA kernel itself is held
against the plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.kernels.pallas_hist import LANES, TILE_ROWS
from genome_tpu.kernels.pallas_hist import digit_histogram_auto as jax_hist
from genome_tpu_torch.kernels import hist
from genome_tpu_torch.kernels.keys import keys_from_pair_np

from tests.torch_cpu import one_torch_thread  # noqa: F401

TILE = TILE_ROWS * LANES


def _pairs(seed, n, n_sent):
    """(hi, lo) uint32 pairs: random keys below 2^42, then n_sent
    sentinel and near-sentinel pairs (hi = 0xFFFFFFFF, lo near the top)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 42, size=n - n_sent, dtype=np.uint64)
    hi = np.concatenate([(keys >> np.uint64(32)).astype(np.uint32),
                         np.full(n_sent, 0xFFFFFFFF, np.uint32)])
    lo = np.concatenate([(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                         (0xFFFFFFFF - rng.integers(0, 3000, n_sent))
                         .astype(np.uint32)])
    return hi, lo


def _numpy_hist(hi, lo, nbits, shift):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    d = (v >> np.uint64(shift)) & np.uint64((1 << nbits) - 1)
    return np.bincount(d.astype(np.int64), minlength=1 << nbits)


@pytest.mark.parametrize("nbits,shift", [(8, 0), (8, 16), (8, 28), (8, 34),
                                         (4, 30), (10, 32), (8, 56),
                                         (1, 63)])
def test_digit_histogram_matches_pallas(nbits, shift):
    hi, lo = _pairs(nbits * 100 + shift, 2 * TILE, 1000)
    want = np.asarray(jax_hist(jnp.asarray(hi), jnp.asarray(lo), nbits,
                               shift))
    got = hist.digit_histogram(torch.from_numpy(keys_from_pair_np(hi, lo)),
                               nbits, shift)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, _numpy_hist(hi, lo, nbits, shift))


def test_sentinels_land_in_the_top_bin_at_bit_63():
    hi, lo = _pairs(5, 5000, 700)
    got = hist.digit_histogram(torch.from_numpy(keys_from_pair_np(hi, lo)),
                               8, 56)
    assert int(got[255]) == 700 and int(got[0]) == 4300


@pytest.mark.parametrize("nbits,shift", [(8, 0), (16, 26), (12, 52)])
def test_digit_histogram_any_length_matches_numpy(nbits, shift):
    # no multiple of the TPU's 32768-key tile
    hi, lo = _pairs(nbits + shift, 12_345, 77)
    got = hist.digit_histogram(torch.from_numpy(keys_from_pair_np(hi, lo)),
                               nbits, shift)
    assert np.array_equal(got.numpy(), _numpy_hist(hi, lo, nbits, shift))
    assert int(got.sum()) == 12_345


def test_digit_histogram_empty_and_cpu_runs_plain_version():
    hist.reset_launches()
    got = hist.digit_histogram(torch.zeros(0, dtype=torch.int64), 4, 0)
    assert got.tolist() == [0] * 16
    assert sum(hist.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["nbits0", "nbits17", "past64", "shift",
                                 "dtype", "2d"])
def test_digit_histogram_rejects_bad_inputs(bad):
    keys = torch.arange(8, dtype=torch.int64)
    nbits, shift = {"nbits0": (0, 0), "nbits17": (17, 0), "past64": (8, 57),
                    "shift": (8, -1)}.get(bad, (8, 0))
    if bad == "dtype":
        keys = keys.to(torch.int32)
    elif bad == "2d":
        keys = keys.view(2, 4)
    with pytest.raises(ValueError):
        hist.digit_histogram(keys, nbits, shift)
