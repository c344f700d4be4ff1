"""A run with the timed path broken underneath has to come out as not
correct: the harness is driven on the CPU, past its look for a card, on
small cells of a copy of the benchmark, once for each fault a cell can
have (one chip: no exchange between chips to leave out)."""

from __future__ import annotations

import types

import pytest

from _assembly_bench_tiny import bench_copy
from assembly_bench import harness

SEED = 2**31 + 4242


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return bench_copy(tmp_path_factory.mktemp("bench"))


def _run(root, cell, wrap=None):
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu", root=root,
                            log=lambda *a, **k: None, wrap_entry=wrap)


def _wrapped(entry, **over):
    ns = types.SimpleNamespace(prepare=entry.prepare, run=entry.run,
                               collect=entry.collect, cleanup=entry.cleanup)
    for k, v in over.items():
        setattr(ns, k, v(entry))
    return lambda _entry: ns


def _stale(entry):
    """A job that hands back the previous job's answer: state that leaks
    from one job into the next."""
    last = {}

    def run(state, job):
        raw = entry.run(state, job)
        prev, last["raw"] = last.get("raw"), (state, raw)
        return prev
    return run


def _stale_collect(entry):
    return lambda state, pair: (None, []) if pair is None \
        else entry.collect(*pair)


def _half_batch(entry):
    """Half of the isolate's reads left out of each job."""
    return lambda codes, *a: entry.prepare(codes[: codes.shape[0] // 2], *a)


def _altered(entry):
    """One base of one contig changed where the answer is produced."""
    def collect(state, raw):
        contigs, events = entry.collect(state, raw)
        c = contigs[len(contigs) // 2]
        flip = "C" if c[0] != "C" else "G"
        contigs[len(contigs) // 2] = flip + c[1:]
        return contigs, events
    return collect


def _raises(entry):
    """Every job of the window raises (the warm-up jobs, numbered below 0,
    run as they are)."""
    def run(state, job):
        if job >= 0:
            raise RuntimeError("device lost")
        return entry.run(state, job)
    return run


@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.cli"])
def test_sound_run_is_correct(root, cell):
    res = _run(root, cell)["result"]
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["jobs_wrong"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("cell", ["tiny.pipeline", "tiny.cli"])
@pytest.mark.parametrize("fault", ["stale", "half_batch", "altered",
                                   "raises"])
def test_fault_is_not_correct(root, cell, fault):
    def wrap(entry):
        over = {"stale": dict(run=_stale, collect=_stale_collect),
                "half_batch": dict(prepare=_half_batch),
                "altered": dict(collect=_altered),
                "raises": dict(run=_raises)}[fault]
        return _wrapped(entry, **over)(entry)
    res = _run(root, cell, wrap)["result"]
    assert not res["correct"]
    assert res["checks"]["jobs_wrong"]["value"] \
        + res["checks"]["jobs_failed"]["value"] >= 1


def test_step_returning_its_state_unchanged_is_not_correct(root,
                                                           monkeypatch):
    """The simplify step hands back the alive mask it was given."""
    from genome_tpu_torch.graph import simplify

    def unchanged(succ, okv, counts, alive, valid_node, params,
                  with_links=False, on_round=None):
        return (alive, None) if with_links else alive
    monkeypatch.setattr(simplify, "simplify_device", unchanged)
    res = _run(root, "tiny.pipeline")["result"]
    assert not res["correct"]
    assert res["checks"]["jobs_wrong"]["value"] == res["attempted"]


def test_control_in_the_programs_place_is_not_correct(root):
    from assembly_bench.control import control_entry
    res = _run(root, "tiny.pipeline", control_entry)["result"]
    assert not res["correct"]
    assert res["checks"]["jobs_wrong"]["value"] == res["attempted"]
