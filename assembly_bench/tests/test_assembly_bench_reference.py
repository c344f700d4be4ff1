"""The benchmark's plain reference against the program's NumPy golden
oracle on small simulated isolates, and its control, which has to differ
from it."""

from __future__ import annotations

import numpy as np
import pytest

import _assembly_bench_tiny  # noqa: F401  (the root on the path)
from assembly_bench import gen, reference

LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def _golden(codes, k, min_coverage=2):
    from genome_tpu_torch.golden import assemble_golden
    from genome_tpu_torch.params import AssemblyParams
    reads = [row.tobytes().decode() for row in LUT[codes]]
    return assemble_golden(reads, AssemblyParams(k=k,
                                                 min_coverage=min_coverage))


HAPLOID = (dict(genome_len=30000, repeat_families=[[2000, 4], [500, 6]],
                repeat_divergence=0.002, read_len=100, error_rate=0.005),
           dict(coverage=25, ploidy=1), 21)
DIPLOID = (dict(genome_len=30000, repeat_families=[[1500, 5]],
                repeat_divergence=0.002, read_len=150, error_rate=0.002),
           dict(coverage=30, ploidy=2, het_rate=0.003), 31)


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 987654321])
@pytest.mark.parametrize("case", [HAPLOID, DIPLOID],
                         ids=["haploid_repeats", "diploid"])
def test_reference_equals_golden(case, seed):
    cfg, cell, k = case
    codes = gen.make_isolate(cfg, cell, seed, 0)
    want = _golden(codes, k)
    got = reference.assemble(codes, k)
    assert len(want) > 10 and got == want


def test_reference_equals_golden_with_invalid_codes():
    cfg, cell, k = HAPLOID
    codes = gen.make_isolate(cfg, cell, 3, 0)
    rng = np.random.default_rng(0)
    codes[rng.random(codes.shape) < 0.002] = 4
    assert reference.assemble(codes, k) == _golden(codes, k)


def test_reference_equals_golden_on_a_cycle():
    # reads of a circular genome, error-free: one cycle, no tips
    rng = np.random.default_rng(11)
    g = rng.integers(0, 4, 3000, dtype=np.uint8)
    starts = rng.integers(0, g.size, 900)
    codes = g[(starts[:, None] + np.arange(100)) % g.size]
    flip = rng.random(900) < 0.5
    codes[flip] = 3 - codes[flip, ::-1]
    want = _golden(codes, 21, min_coverage=1)
    assert len(want) == 1 and len(want[0]) >= 3000
    assert reference.assemble(codes, 21, min_coverage=1) == want


@pytest.mark.parametrize("seed", [4, 2**31 + 9])
@pytest.mark.parametrize("case", [HAPLOID, DIPLOID],
                         ids=["haploid_repeats", "diploid"])
def test_control_fails(case, seed):
    """The control: bubbles keep their side by head k-mer alone, breaking
    the configurations' higher-count-sum guarantee. It must not pass."""
    cfg, cell, k = case
    codes = gen.make_isolate(cfg, cell, seed, 0)
    assert reference.assemble(codes, k, control=True) \
        != reference.assemble(codes, k)
