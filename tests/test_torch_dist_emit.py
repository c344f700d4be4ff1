"""dist/emit.py::contigs_from_gathered, the sharded emission's decode on
the device, against the plain host decode (tests/torch_emit_gathered.py)
on gathered rows built in process at S = 1, 2 and 4: no process group."""

import numpy as np
import pytest
import torch

from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.dist.emit import BLOCK, contigs_from_gathered
from genome_tpu_torch.utils import dna

from tests.torch_cpu import one_torch_thread  # noqa: F401
from tests.torch_emit_gathered import gathered_case, host_decode

K = 7


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def _seqs(case, rng):
    """Each case's chains: its special ones and a few random ones."""
    special = {
        # chains of up to four blocks, two ending on a block boundary
        "multi_block": [_rand(rng, n) for n in
                        (3 * BLOCK + 200, 2 * BLOCK + K - 1, BLOCK + K,
                         4 * BLOCK + K - 1)],
        "single_node": ["TTTACGA", "ACGTACG", "GATCGAT", "CCCCCCC"],
        "revcomp_smaller": ["TTTTTACGT", "GGGTTTTTTT"],
        "even_palindrome": ["AACCGGTT", "GAATTC" * 2, "ACGCGCGT",
                            "AAAA" * 300 + "TTTT" * 300],
        # mirrored outside, first mismatch at j = 9 > k: forward, then
        # reversed
        "mismatch_past_k": ["AAACCCGGTGAACCGGGTTT",
                            "AAACCCGGTTCACCGGGTTT"],
        "min_contig_len": ["TTTTTTT", "ACGTACG" * 4, "GGGGCCCCA"],
        "empty": [],
    }[case]
    if case == "empty":
        return []
    return special + [_rand(rng, rng.integers(K, 1500)) for _ in range(5)]


CASES = ["multi_block", "single_node", "revcomp_smaller", "even_palindrome",
         "mismatch_past_k", "min_contig_len", "empty"]


def _run(rows, min_contig_len=0, local_slice=None):
    m = Metrics(quiet=True)
    with m.phase("dist_contigs"):
        got = contigs_from_gathered(*(torch.from_numpy(x) for x in rows), K,
                                    min_contig_len, local_slice)
    end = next(e for e in m.events if e["event"] == "phase_end")
    return got, end


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_device_decode_equals_host_decode(case, S):
    """The contigs equal the host decode's, and the canonical strings of
    the chains; contigs_reversed counts those whose reverse complement is
    smaller (before min_contig_len) and d2h_bytes is every contig's bases
    and 3 int64 a contig; three host reads, one where there are no
    contigs."""
    rng = np.random.default_rng(len(case) * 10 + S)
    seqs = _seqs(case, rng)
    rows = gathered_case(seqs, S, K, seed=S)
    ml = 12 if case == "min_contig_len" else 0
    want = host_decode(*rows, K, ml)
    assert want == sorted(min(s, dna.revcomp_str(s)) for s in seqs
                          if len(s) >= ml)
    got, end = _run(rows, ml)
    assert got == want
    assert end.get("contigs_reversed", 0) == sum(
        dna.revcomp_str(s) < s for s in seqs)
    assert end.get("d2h_bytes", 0) == sum(map(len, seqs)) + 24 * len(seqs)
    assert end["syncs"] == (3 if seqs else 1)
    if case == "multi_block" and S > 1:
        assert (rows[-1][:, 0] > 0).sum() > 1  # blocks on several ranks
    if case == "min_contig_len":
        assert len(want) < len(seqs)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_local_slices_equal_host_decode(S):
    """Every local_slice at P = 1..4 equals the host decode's slice; the
    slices of each P together are the whole contig set; with 3 contigs at
    P = 4 the last slice is empty."""
    rng = np.random.default_rng(S)
    for seqs in ([_rand(rng, n) for n in (2 * BLOCK + 50, K, 40)],
                 _seqs("multi_block", rng)):
        rows = gathered_case(seqs, S, K, seed=S + 7)
        full = host_decode(*rows, K)
        for P in range(1, 5):
            parts = []
            for pid in range(P):
                want = host_decode(*rows, K, 0, (pid, P))
                got, end = _run(rows, 0, (pid, P))
                assert got == want
                assert end.get("d2h_bytes", 0) == (
                    sum(map(len, got)) + 24 * len(got))
                parts.append(got)
            assert sorted(sum(parts, [])) == full
            if len(seqs) == 3 and P == 4:
                assert parts[-1] == []


@pytest.mark.parametrize("local_slice", [None, (3, 4)])
@pytest.mark.parametrize("S", [1, 2, 4])
def test_missing_head_raises(S, local_slice):
    """A chain head with no k-mer record raises AssertionError, as the
    host decode does, whatever the slice: the check runs on the global
    head set."""
    rng = np.random.default_rng(5)
    rows = gathered_case([_rand(rng, 30) for _ in range(3)], S, K, seed=S,
                         drop_head=True)
    with pytest.raises(AssertionError):
        host_decode(*rows, K, 0, local_slice)
    with pytest.raises(AssertionError, match="missing"):
        _run(rows, 0, local_slice)
