"""The `multihost` entry and the chr14 configuration on the CPU: a gloo
group of two ranks (the harness process and one worker) runs a small
copy of chr14_k31 through run_cell, correct, with the new per-layer
metrics read; the control makes its jobs wrong; a worker that fails ends
its job; no worker outlives the run."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from _assembly_bench_tiny import ROOT
from assembly_bench import control, gen, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "chr14_k31.multihost30"
SEED = 2**31 + 2323
NEW = ("dist_extract_ms", "dist_count_ms", "dist_build_ms",
       "dist_simplify_ms", "dist_final_ms", "dist_emit_ms", "exchange_ms",
       "exchange_mib", "exchange_calls", "dist_escapes")
# chr14_k31 at 20 kbp: 10 Alu-like copies, 3 L1-like ones of 2 kb, and 2
# ranks; its reads as the cell makes them
TINY = dict(genome_len=20000, repeat_families=[[300, 10], [2000, 3]],
            ranks=2)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout-like root: the benchmark with chr14_k31 cut to TINY."""
    dst = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "assembly_bench", dst / "assembly_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    path = dst / "assembly_bench/configs/chr14_k31.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY)
    path.write_text(json.dumps(cfg))
    return dst


def _run(root, wrap=None, seconds=0.5):
    return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                            root=root, log=lambda *a, **k: None,
                            wrap_entry=wrap)


class _Spy:
    """The entry itself, with the worker processes it started noted."""

    def __init__(self):
        self.entry, self.workers = None, []

    def __call__(self, entry):
        self.entry = entry
        return self

    def prepare(self, *args):
        state = self.entry.prepare(*args)
        self.workers = list(self.entry._GROUP["workers"])
        return state

    def run(self, state, job):
        return self.entry.run(state, job)

    def collect(self, state, raw):
        return self.entry.collect(state, raw)

    def cleanup(self, state):
        return self.entry.cleanup(state)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


@pytest.fixture(scope="module")
def run(root):
    spy = _Spy()
    return dict(out=_run(root, spy), spy=spy)


def test_cell_in_the_benchmark():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["chips"] == 4
    assert cells["ecoli_k21.codes24"]["chips"] == 1
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 1
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["workloads"] == [CELL] and m["moves"] == "bases_per_s"
    for name in ("setup_s", "bases_per_s"):
        assert name in {m["name"] for m in harness.cell_metrics(BENCH, CELL,
                                                                False)}
    for cell in (CELL, "ecoli_k21.codes24"):
        assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("cell,reads", [(CELL, 26_224_615),
                                        ("ecoli_k21.codes24", 1_113_996)])
def test_stated_read_counts(cell, reads):
    c = harness.load_cell(cell)
    cfg = harness.load_config(c["config"])
    assert gen.n_reads(cfg, c) == reads and c.get("isolates", 2) == 2
    if cell == CELL:
        # 465.5 M windows a rank: local_cap stays 2^29
        windows = reads * (cfg["read_len"] - cfg["k"] + 1)
        assert windows == 1_861_947_665 < 2**31
        assert 2**28 < windows / cfg["ranks"] < 2**29


def test_entry_runs_the_cell_correct(run):
    res = run["out"]["result"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert {"setup_s", "bases_per_s"} <= set(res["metrics"])


@pytest.mark.parametrize("name", NEW)
def test_new_metrics_read(run, name):
    """Each new reader reads rank 0's events; exchange_ms reads the
    spans' CUDA events, which a CPU group has none of."""
    v = harness.load_metric(name).read(run["out"]["record"])
    if name == "exchange_ms":
        assert v is None
    elif name == "dist_escapes":
        assert v == 0
    else:
        assert v is not None and v > 0


def test_cleanup_leaves_no_worker(run):
    spy = run["spy"]
    assert len(spy.workers) == 1
    assert all(p.returncode == 0 for p in spy.workers)
    assert all(_gone(p.pid) for p in spy.workers)
    assert spy.entry._GROUP == {}


def test_control_makes_jobs_wrong(root):
    out = _run(root, control.control_entry)
    c = out["checks"]
    assert not out["result"]["correct"]
    assert c["jobs_wrong"]["value"] == out["result"]["attempted"] > 0


def test_parent_program_fails_before_any_worker(root, monkeypatch):
    """A program whose assemble_multihost takes no metrics= (the commit
    before the entry) fails in the first prepare, with no process
    started."""
    from genome_tpu_torch.dist import multihost

    def assemble_multihost(local_reads, params=None, device="cuda"):
        raise AssertionError("never called")
    monkeypatch.setattr(multihost, "assemble_multihost", assemble_multihost)
    spy = _Spy()
    with pytest.raises(RuntimeError, match="takes no metrics="):
        _run(root, spy)
    assert spy.workers == [] and spy.entry._GROUP == {}


def test_failing_worker_fails_its_job(root):
    """A worker that raises (sent an isolate it has no shard of) exits;
    rank 0's job fails at its first collective, and every later job at
    once; cleanup still leaves the group, with no worker left."""
    import torch.distributed as dist

    class Broken(_Spy):
        def run(self, state, job):
            if job == 0:
                state = dict(state, name="missing")
            return self.entry.run(state, job)
    spy = Broken()
    out = _run(root, spy, seconds=2.0)
    res = out["result"]
    assert not res["correct"] and res["failed"] == res["attempted"] >= 2
    assert [p.returncode for p in spy.workers] == [1]
    assert all(_gone(p.pid) for p in spy.workers)
    assert not dist.is_initialized()
