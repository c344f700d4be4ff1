"""The isolate generator on the CPU: the real configurations draw the same
isolates byte for byte as before a configuration could state circular
molecules, and a configuration's replicons get their stated reads,
wrapping the origin where circular, in a shuffled matrix."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from _assembly_bench_tiny import ROOT  # noqa: F401  (the root on the path)
from assembly_bench import gen, harness

# sha256 of make_isolate(config, coverage 1, seed, isolate 0), computed
# with the generator as it was before the `circular` and `replicons` keys
# existed: a configuration that states neither must draw these bytes
PINNED = {
    ("ecoli_k21", 1, 7): "d0cba7b19dc9b353c28cd34f49c8f889"
                         "50cdbee19a087a2dcf3ba0cd3e292bc7",
    ("ecoli_k21", 1, 2**31 + 101): "cc5e602b26a9fd907359d1023c64045e"
                                   "24b16308978dfc0ed36fc5353202ef17",
    ("yeast_k31", 1, 7): "69c79d2f8e968432e72d0629b061dc24"
                         "21e748ad9873686326edc28fcc21e82b",
    ("yeast_k31", 1, 2**31 + 101): "4df5119fb08d07d8975b701a00d9f48b"
                                   "80b2b59b31e308e5d5b83893b136eddd",
    ("yeast_k31", 2, 7): "32ddc2f87b8daf9711b1558ad6a90947"
                         "887a784fd8d1c04f7b59b85316a6adfc",
    ("yeast_k31", 2, 2**31 + 101): "1b403d1847c0c5797daddfcca4581eb9"
                                   "3844cbe7c33e9ed6d7932fe1cc685020",
    ("chr14_k31", 1, 7): "1f54b787db391c74b7dd1b448642c5b4"
                         "99fff440560c5aaa7db9cd218ade1d98",
    ("chr14_k31", 1, 2**31 + 101): "923402ab19647bdf6c2e7a9cf3f65a75"
                                   "28cc213086a3ba81aca67e20573dc43f",
}


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: "-".join(
    map(str, k)))
def test_real_configurations_draw_the_pinned_isolates(key):
    name, ploidy, seed = key
    cfg = harness.load_config(name)
    assert "circular" not in cfg and "replicons" not in cfg
    cell = dict(coverage=1, ploidy=ploidy, het_rate=0.001)
    codes = gen.make_isolate(cfg, cell, seed, 0)
    assert codes.shape == (gen.n_reads(cfg, cell), cfg["read_len"])
    assert hashlib.sha256(codes).hexdigest() == PINNED[key]


# error-free reads, so each read is a window of its molecule or of its
# reverse complement
CFG = dict(genome_len=5000, repeat_families=[[400, 2]],
           repeat_divergence=0.002, read_len=50, error_rate=0.0,
           replicons=[dict(name="ring", length=1000, circular=True,
                           copies=3),
                      dict(name="rod", length=800, circular=False,
                           copies=2.5)])
CELL = dict(coverage=4, ploidy=2, het_rate=0.01)
SEED = 2**31 + 77


def _windows(seq: np.ndarray, L: int, circular: bool) -> dict:
    """Each L-window of `seq` and of its reverse complement, as bytes ->
    the window's start on the forward strand."""
    n = seq.size
    ext = np.concatenate([seq, seq[: L - 1]]) if circular else seq
    out = {}
    for s in range(n if circular else n - L + 1):
        w = ext[s : s + L]
        out[w.tobytes()] = s
        out[(3 - w[::-1]).tobytes()] = s
    return out


def _starts(reads: np.ndarray, seqs, L: int, circular: bool) -> list[int]:
    """The start of each read on whichever of `seqs` holds it."""
    windows = {}
    for seq in seqs:
        windows.update(_windows(seq, L, circular))
    return [windows[r.tobytes()] for r in reads]


def test_replicons_get_their_stated_reads():
    mols, perm = gen._isolate(CFG, CELL, SEED, 0, "cpu")
    counts = gen.read_counts(CFG, CELL)
    assert counts == [("chromosome", 4 * 5000 // 50),
                      ("ring", int(4 * 3 * 1000 // 50)),
                      ("rod", int(4 * 2.5 * 800 // 50))]
    assert gen.n_reads(CFG, CELL) == 400 + 240 + 160
    assert [m[0] for m in mols] == ["chromosome", "ring", "rod"]
    assert [m[3].shape[0] for m in mols] == [n for _, n in counts]
    L = CFG["read_len"]
    # the chromosome's two haplotypes; one sequence for each replicon
    assert len(mols[0][1]) == 2 and all(len(m[1]) == 1 for m in mols[1:])
    for name, seqs, circular, reads in mols:
        starts = _starts(reads.numpy(), [s.numpy() for s in seqs], L,
                         circular)
        n = seqs[0].numel()
        wrapped = [s for s in starts if s > n - L]
        if circular:  # about (L - 1) / n of the reads span its origin
            assert len(wrapped) > 0, name
        else:
            assert not wrapped, name


def test_a_circular_chromosome_wraps_its_origin():
    cfg = dict(CFG, circular=True, replicons=[])
    mols, perm = gen._isolate(cfg, dict(coverage=20, ploidy=1), SEED, 0,
                              "cpu")
    (_, [seq], circular, reads), = mols
    assert circular and perm is None
    starts = _starts(reads.numpy(), [seq.numpy()], 50, True)
    assert max(starts) > 5000 - 50


def test_rows_shuffled_only_where_replicons_are_stated():
    codes = gen.make_isolate(CFG, CELL, SEED, 0)
    mols, perm = gen._isolate(CFG, CELL, SEED, 0, "cpu")
    whole = torch.cat([m[3] for m in mols])
    assert perm is not None
    assert np.array_equal(codes, whole[perm].numpy())
    assert not np.array_equal(codes, whole.numpy())
    # the chromosome's draws come first, as without replicons
    bare = dict(CFG, replicons=[])
    assert gen._isolate(bare, CELL, SEED, 0, "cpu")[1] is None
    assert np.array_equal(gen.make_isolate(bare, CELL, SEED, 0),
                          mols[0][3].numpy())


def test_replicon_isolates_deterministic_per_seed_and_index():
    a = gen.make_isolate(CFG, CELL, SEED, 0)
    assert np.array_equal(a, gen.make_isolate(CFG, CELL, SEED, 0))
    assert not np.array_equal(a, gen.make_isolate(CFG, CELL, SEED, 1))
    assert not np.array_equal(a, gen.make_isolate(CFG, CELL, SEED + 1, 0))
    assert a.shape == (800, 50) and a.dtype == np.uint8 and a.max() <= 3
