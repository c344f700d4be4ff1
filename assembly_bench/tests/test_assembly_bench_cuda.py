"""On the card (marker `cuda`; skips without one): a small cell run
through the harness with the trace on, as a `--trace 1` run makes it.

    python -m pytest -m cuda assembly_bench/tests
"""

from __future__ import annotations

import pytest
import torch

from _assembly_bench_tiny import bench_copy
from assembly_bench import harness


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.cli"])
def test_traced_run_on_the_card(card, tmp_path, cell):
    root = bench_copy(tmp_path)
    res = harness.run_cell(cell, 2**31 + 3, 2.0, True, device="cuda",
                           root=root, log=lambda *a, **k: None)["result"]
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    assert {"count_ms", "simplify_rounds", "compact_us_per_call",
            "device_idle_pct"} <= set(res["metrics"])
    assert 0 < len(res["breakdown"]["device_ops"]) <= 10
    assert 0 < len(res["breakdown"]["idle_gaps"]) <= 10
