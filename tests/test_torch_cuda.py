"""The `cuda` lane: the port's CUDA kernel and its main path on the card,
held against the plain versions on the same inputs (exact: integer
outputs). Skips without a card; the fixture decides, never import time.

On a machine with the card:
    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
--noconftest skips tests/conftest.py, which imports JAX, and this file
imports nothing of JAX, so the lane needs only torch there.
"""

import pytest
import torch

from genome_tpu_torch.assemble.pipeline import run_pipeline
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels import compact
from genome_tpu_torch.params import AssemblyParams


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m cuda "
                    "--noconftest tests/test_torch_cuda.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,ncols,cap", [
    (0, 0.5, 1, 16), (1, 1.0, 1, 1), (1025, 0.5, 2, 2048),
    (1025, 0.0, 1, 2048), (1025, 1.0, 1, 2048), (100_000, 0.5, 1, 1000),
    (12_305, 0.3, 6, 50_000), (3_000_000, 0.1, 2, 1 << 20)])
def test_compact_kernel_matches_plain_on_card(cuda_device, n, p, ncols, cap):
    g = torch.Generator(device=cuda_device)
    g.manual_seed(n)
    flags = torch.rand(n, device=cuda_device, generator=g) < p
    arrays = tuple(torch.randint(-2**31, 2**31 - 1, (n,), device=cuda_device,
                                 generator=g,
                                 dtype=(torch.int64, torch.int32)[i % 2])
                   for i in range(ncols))
    got = compact.compact_flagged(flags, arrays, cap)
    want = compact.compact_flagged_ref(flags, arrays, cap)
    torch.cuda.synchronize()
    assert int(got[2]) == int(want[2]) and bool(got[3]) == bool(want[3])
    m = min(int(want[2]), cap)
    for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)):
        assert torch.equal(a[:m], b[:m])


@pytest.mark.cuda
def test_pipeline_on_card_equals_cpu(cuda_device):
    reads = simulate_reads(random_genome(3000, seed=123), read_len=100,
                           coverage=25, error_rate=0.01, seed=7)
    params = AssemblyParams(k=21, min_coverage=2)
    compact.reset_launches()
    got = run_pipeline(reads, params, device=cuda_device)["contigs"]
    assert got == run_pipeline(reads, params, device="cpu")["contigs"]
    assert all(compact.LAUNCHES[s] > 0 for s in compact.SITES
               if s != "tails")
