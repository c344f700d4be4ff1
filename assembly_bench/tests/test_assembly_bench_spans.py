"""The readers of the program's spans and counters: each returns its
value from a record with span events and counter fields, None from a
record without them (a program that writes neither), and the older
readers read the same values with or without them."""

from __future__ import annotations

import json

import pytest

from _assembly_bench_tiny import ROOT
from assembly_bench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("parse_scan_ms", "count_extract_ms", "count_sort_ms",
       "count_runs_ms", "h2d_mib", "emit_device_ms", "emit_strings_ms",
       "host_syncs", "simplify_wait_ms", "retries")
OLD = sorted({m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]}
             - set(NEW))


def _span(name, t0, dur, parent="p", device_ms=False):
    e = dict(event="span", name=name, parent=parent, run="r", t0=t0,
             t1=t0 + dur)
    if device_ms is not False:
        e["device_ms"] = device_ms
    return e


def _end(phase, wall, syncs=0, wait=0.0, retries=0, h2d=0, **kw):
    return dict(event="phase_end", phase=phase, ts=100.0, wall_s=wall,
                syncs=syncs, sync_wait_s=wait, retries=retries,
                h2d_bytes=h2d, sync_sites={}, **kw)


def _job_events(cli: bool, scale: float):
    """One job: phases with counters, and spans; a capacity retry runs a
    second sort and run pass."""
    ev = []
    if cli:
        ev += [_span("parse.scan", 10.0, 0.040 * scale, "read_input"),
               _span("parse.index", 10.1, 0.030 * scale, "read_input"),
               _span("parse.decode", 10.2, 0.050 * scale, "read_input"),
               _end("read_input", 0.2 * scale, n_reads=5)]
    ev += [_span("count.pack", 11.0, 0.01, "count.extract"),
           _span("count.extract", 11.0, 0.05, "count.reads",
                 device_ms=40.0 * scale),
           _span("count.sort", 11.1, 0.02, "count.reads", device_ms=20.0),
           _span("count.runs", 11.2, 0.01, "count.reads", device_ms=5.0),
           _span("count.sort", 11.3, 0.02, "count.reads", device_ms=22.0),
           _span("count.runs", 11.4, 0.01, "count.reads", device_ms=6.0),
           _span("count.reads", 11.0, 0.45, "count"),
           _end("count", 0.5, syncs=2, wait=0.001, retries=1,
                h2d=3 * 2**20 * scale),
           _end("build", 0.02, syncs=1, wait=0.004),
           dict(event="simplify_round", wall_s=0.1),
           _end("simplify", 0.3 * scale, syncs=11, wait=0.05 * scale),
           _span("final", 12.0, 0.01, "contigs"),
           _span("emit.device", 12.1, 0.004 * scale, "emit"),
           _span("emit.copy", 12.2, 0.002, "emit"),
           _span("emit.strings", 12.3, 0.060 * scale, "emit"),
           _span("emit", 12.1, 0.07, "contigs"),
           _end("contigs", 0.08, syncs=20, wait=0.003, final_s=0.01,
                emit_s=0.07),
           dict(event="done")]
    return ev


def _record(cli: bool, spans: bool = True):
    jobs = []
    for i, scale in enumerate((1.0, 2.0)):
        ev = _job_events(cli, scale)
        if not spans:  # as the parent program writes them
            ev = [{k: v for k, v in e.items()
                   if k not in ("syncs", "sync_wait_s", "retries",
                                "h2d_bytes", "sync_sites")}
                  for e in ev if e["event"] != "span"]
        jobs.append(dict(isolate=i, wall_s=1.0 + i, bases=1000, events=ev,
                         t0_wall=10.0 + 10 * i, t1_wall=11.0 + 10 * i))
    return dict(setup_s=12.5, window_s=4.0, peak_bytes=2**30, jobs=jobs,
                launches={"compact": 4}, trace=None)


EXPECTED = {
    # (0.040 + 0.030) and twice that, in ms
    "parse_scan_ms": (105.0, None),
    "count_extract_ms": (60.0, 60.0),
    # two sorts and two run passes a job
    "count_sort_ms": (42.0, 42.0),
    "count_runs_ms": (11.0, 11.0),
    "h2d_mib": (4.5, 4.5),
    "emit_device_ms": (6.0, 6.0),
    "emit_strings_ms": (90.0, 90.0),
    "host_syncs": (34.0, 34.0),
    "simplify_wait_ms": (75.0, 75.0),
    "retries": (1.0, 1.0),
}


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("cli", [True, False], ids=["cli", "pipeline"])
def test_new_reader_values(name, cli):
    got = harness.load_metric(name).read(_record(cli))
    want = EXPECTED[name][0 if cli else 1]
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name", NEW)
def test_new_readers_silent_without_spans_and_counters(name):
    assert harness.load_metric(name).read(_record(True, spans=False)) is None


@pytest.mark.parametrize("name", ["count_extract_ms", "count_sort_ms",
                                  "count_runs_ms"])
def test_device_readers_silent_where_no_device_time_was_read(name):
    rec = _record(False)
    for job in rec["jobs"]:
        for e in job["events"]:
            if "device_ms" in e:
                e["device_ms"] = None
    assert harness.load_metric(name).read(rec) is None


@pytest.mark.parametrize("name", OLD)
@pytest.mark.parametrize("cli", [True, False], ids=["cli", "pipeline"])
def test_older_readers_unchanged_by_spans_and_counters(name, cli):
    mod = harness.load_metric(name)
    assert mod.read(_record(cli)) == mod.read(_record(cli, spans=False))


def test_new_metrics_appended_to_the_benchmark():
    """These ten follow the first benchmark's metrics, and only the
    sharded cell's dist metrics follow them; they are read in every
    one-card cell (parse_scan_ms in the cli one), and the counters that
    the sharded path writes too in the sharded cell, added last."""
    names = [m["name"] for m in BENCH["per_layer"]]
    at = names.index(NEW[0])
    assert tuple(names[at : at + len(NEW)]) == NEW
    one = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
    sharded = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]
    for m in BENCH["per_layer"][at : at + len(NEW)]:
        assert m["moves"] == "bases_per_s" and m["better"] == "lower"
        want = ["ecoli_k21.fastq24"] if m["name"] == "parse_scan_ms" \
            else one + sharded if m["name"] in ("host_syncs", "retries") \
            else one
        assert m["workloads"] == want
    later = BENCH["per_layer"][at + len(NEW):]
    assert later and all(m["workloads"] == sharded for m in later)
