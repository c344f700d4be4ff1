"""The readers of the sharded emission's spans: dist_emit_device_ms and
dist_emit_strings_ms are the mean host walls a job of `dist_emit.device`
and `dist_emit.strings`, None from a program that logs neither (a parent
without them, or the gathered fallback's one-card `emit.*` spans)."""

from __future__ import annotations

import json

import pytest

from _assembly_bench_tiny import ROOT
from assembly_bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"dist_emit_device_ms": "dist_emit.device",
       "dist_emit_strings_ms": "dist_emit.strings"}


def _span(name, t0, dur):
    return dict(event="span", name=name, parent="dist_contigs", run="r",
                t0=t0, t1=t0 + dur)


def _record(names):
    """Two jobs, the second without a dist_contigs phase of its own."""
    ev = [_span(n, 10.0 + i, 0.002 * (i + 1)) for i, n in enumerate(names)]
    ev += [_span("dist_emit.copy", 12.0, 0.001),
           _span("emit.device", 12.5, 0.5), _span("emit.strings", 13.0, 0.5)]
    return {"jobs": [{"events": ev}, {"events": []}]}


@pytest.mark.parametrize("name", list(NEW))
def test_reader_reads_its_span(name):
    mod = harness.load_metric(name)
    span = NEW[name]
    got = mod.read(_record([span, span]))
    assert got == pytest.approx(2.0 + 4.0)  # both spans of the one job
    assert mod.read(_record([])) is None


def test_appended_for_the_sharded_cell():
    per_layer = BENCH["per_layer"]
    assert [m["name"] for m in per_layer[-2:]] == list(NEW)
    for m in per_layer[-2:]:
        assert m["workloads"] == ["chr14_k31.multihost30"]
        assert (m["moves"], m["layer"], m["source"]) == (
            "bases_per_s", "dist emission", "program_span")
