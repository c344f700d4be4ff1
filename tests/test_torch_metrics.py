"""The port's tracing (`assemble/metrics.py`): spans, counters and their
microsecond times, and the spans and counters that the pipeline and the
CLI log on the CPU, with the contigs unchanged when work is redone."""

import functools
import json
import time

import pytest
import torch

from assembly_bench import records
from genome_tpu_torch.assemble import cli, pipeline
from genome_tpu_torch.assemble.metrics import (COUNTERS, Metrics, count,
                                               host_read, span)
from genome_tpu_torch.assemble.pipeline import run_pipeline
from genome_tpu_torch.golden import assemble_golden
from genome_tpu_torch.graph import simplify as graph_simplify
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels.extract import pack_reads
from genome_tpu_torch.params import AssemblyParams

from tests.torch_cpu import one_torch_thread  # noqa: F401

PIPELINE_SPANS = ("count.reads", "count.extract", "count.pack", "count.sort",
                  "count.runs", "final", "emit", "emit.device", "emit.copy",
                  "emit.strings")
PARSE_SPANS = ("parse.scan", "parse.index", "parse.decode", "parse.bases")


def _spans(events):
    return [e for e in events if e["event"] == "span"]


def _ends(events):
    return {e["phase"]: e for e in events if e["event"] == "phase_end"}


@functools.lru_cache(maxsize=None)
def _reads():
    return tuple(simulate_reads(random_genome(3000, seed=123), read_len=100,
                                coverage=25, error_rate=0.01, seed=7))


PARAMS = AssemblyParams(k=21, min_coverage=2)


@functools.lru_cache(maxsize=None)
def _want():
    return tuple(assemble_golden(list(_reads()), PARAMS))


def _job(**kw):
    m = Metrics(quiet=True)
    res = run_pipeline(pack_reads(list(_reads())), PARAMS, metrics=m,
                       device="cpu", **kw)
    return res["contigs"], m.events


def test_span_nesting_and_parent():
    m = Metrics(quiet=True)
    with m.phase("p"):
        with span("a"):
            with span("b"):
                pass
            with m.phase("q"):  # a nested phase takes the spans inside it
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):
            pass
    got = {e["name"]: e for e in _spans(m.events)}
    assert {n: e["parent"] for n, e in got.items()} == {
        "a": "p", "b": "a", "c": "q", "d": "a", "e": "p"}
    assert {e["run"] for e in got.values()} == {m.run}
    assert Metrics(quiet=True).run != m.run
    a, b, d, e = got["a"], got["b"], got["d"], got["e"]
    assert a["t0"] <= b["t0"] <= b["t1"] <= d["t0"] <= d["t1"] <= a["t1"] \
        <= e["t0"]
    # each phase's spans are written just before its phase_end
    kinds = [(x["event"], x.get("phase", x.get("name"))) for x in m.events]
    assert kinds == [("phase_start", "p"), ("phase_start", "q"),
                     ("span", "c"), ("phase_end", "q"), ("span", "b"),
                     ("span", "d"), ("span", "a"), ("span", "e"),
                     ("phase_end", "p")]


def test_times_to_the_microsecond_and_spans_inside_their_phase(tmp_path):
    path = tmp_path / "m.jsonl"
    m = Metrics(path=str(path), quiet=True)
    with m.phase("p"):
        with span("a") as a:
            time.sleep(0.003)
        # spans are not flushed one by one
        assert [json.loads(x)["event"] for x in
                path.read_text().splitlines()] == ["phase_start"]
    m.close()
    start, sp, end = m.events
    assert [json.loads(x) for x in path.read_text().splitlines()] == m.events
    for x in (start["ts"], end["ts"], end["wall_s"], sp["t0"], sp["t1"]):
        assert x == round(x, 6)
    assert a.wall_s >= 0.003
    assert sp["t1"] - sp["t0"] == pytest.approx(a.wall_s, abs=2e-6)
    # the phase rebuilt from its end event, as the benchmark does, holds
    # its span to the microsecond
    assert end["ts"] - end["wall_s"] - 2e-6 <= sp["t0"]
    assert sp["t1"] <= end["ts"] + 2e-6


def test_span_and_counters_without_metrics_log_nothing():
    m = Metrics(quiet=True)
    with span("a", device=torch.device("cpu")) as s:
        count("retries")
        assert host_read("site", lambda: 7) == 7
    assert s.wall_s >= 0 and m.events == []


def test_counters_are_fields_of_phase_end():
    m = Metrics(quiet=True)
    with m.phase("p") as info:
        count("retries")
        count("h2d_bytes", 1024)
        count("h2d_bytes", 1024)
        assert host_read("x", lambda: time.sleep(0.002) or 5) == 5
        host_read("x", lambda: None)
        host_read("y", lambda: None)
        info["n"] = 1
    with m.phase("empty"):
        pass
    end = _ends(m.events)
    assert end["p"]["syncs"] == 3 and end["p"]["retries"] == 1
    assert end["p"]["h2d_bytes"] == 2048 and end["p"]["n"] == 1
    assert end["p"]["sync_wait_s"] >= 0.002
    assert end["p"]["sync_sites"] == {"x": 2, "y": 1}
    assert {k: end["empty"][k] for k in COUNTERS} == dict.fromkeys(COUNTERS,
                                                                   0)


def test_device_span_on_the_cpu_reads_no_device_time():
    m = Metrics(quiet=True)
    with m.phase("p"):
        with span("a", device=torch.device("cpu")):
            torch.ones(8).sum()
        with span("b"):
            pass
    a, b = _spans(m.events)
    assert a["device_ms"] is None and "device_ms" not in b


def test_metrics_span_goes_to_its_own_metrics():
    a, b = Metrics(quiet=True), Metrics(quiet=True)
    with a.span("outside") as s:
        pass
    assert s.wall_s >= 0 and a.events == []
    with a.phase("pa"):
        with b.phase("pb"):  # b is current
            with a.span("x"):
                pass
    (x,) = _spans(a.events)
    assert (x["name"], x["parent"], x["run"]) == ("x", "pa", a.run)
    assert not _spans(b.events)


def test_span_events_never_count_as_phase_end():
    m = Metrics(quiet=True)
    w0 = time.time()
    for ph in records.PHASES:
        with m.phase(ph) as info:
            with span(f"{ph}.work"):
                count("retries")
            if ph == "contigs":
                info.update(final_s=0.001, emit_s=0.002)
    job = dict(wall_s=1.0, t0_wall=w0, t1_wall=time.time())
    rec = dict(jobs=[dict(job, events=m.events)])
    bare = dict(jobs=[dict(job, events=[e for e in m.events
                                        if e["event"] != "span"])])
    assert len(_spans(m.events)) == len(records.PHASES)
    for ph in records.PHASES:
        assert records.phase_ms(rec, ph) == records.phase_ms(bare, ph)
        assert records.phase_ms(rec, ph) is not None
    assert records.phase_ms(rec, "contigs", "emit_s") == 2.0
    assert records.spans(rec) == records.spans(bare)


def test_each_pipeline_span_once_a_job_with_unchanged_contigs():
    for _ in range(2):
        contigs, events = _job()
        assert contigs == list(_want())
        names = [e["name"] for e in _spans(events)]
        assert sorted(names) == sorted(PIPELINE_SPANS)
        ends = _ends(events)
        for e in ends.values():
            assert set(COUNTERS) <= set(e) and e["retries"] == 0
            assert e["h2d_bytes"] == 0  # no upload crosses to a card here
        # the alive count after simplify is read once
        assert ends["simplify"]["sync_sites"]["simplify.alive"] == 1
        assert ends["simplify"]["sync_sites"]["simplify.round"] >= 1
        sp = {e["name"]: e for e in _spans(events)}
        assert ends["contigs"]["final_s"] == pytest.approx(
            sp["final"]["t1"] - sp["final"]["t0"], abs=2e-6)
        assert ends["contigs"]["emit_s"] == pytest.approx(
            sp["emit"]["t1"] - sp["emit"]["t0"], abs=2e-6)
        assert sp["count.extract"]["device_ms"] is None


def test_cli_logs_parse_spans_in_its_read_input_phase(tmp_path):
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(_reads())))
    jsonl = tmp_path / "m.jsonl"
    assert cli.main([str(fq), "-o", str(tmp_path / "c.fasta"), "--device",
                     "cpu", "--quiet", "--metrics", str(jsonl)]) == 0
    ev = [json.loads(x) for x in jsonl.read_text().splitlines()]
    got = [e["name"] for e in _spans(ev)]
    assert sorted(got) == sorted(PIPELINE_SPANS + PARSE_SPANS)
    assert {e["parent"] for e in _spans(ev)
            if e["name"] in PARSE_SPANS} == {"read_input"}
    read_input = _ends(ev)["read_input"]
    assert read_input["n_reads"] == len(_reads())
    assert read_input["total_bp"] == 100 * len(_reads())


def test_spans_in_the_profile_trace(tmp_path):
    """--profile's trace holds the block's annotation and a
    record_function of each span of the job."""
    m = Metrics(quiet=True)
    run_pipeline(list(_reads()), PARAMS, metrics=m, device="cpu",
                 profile_dir=str(tmp_path))
    with open(tmp_path / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {pipeline.PROFILE_ANNOTATION, *PIPELINE_SPANS} <= names
    # the string path packs each batch, as a code matrix's chunks are
    assert "count.pack" in {e["name"] for e in _spans(m.events)}


@pytest.mark.parametrize("case", ["walk_ladder", "kill_buffer", "tails",
                                  "capacity", "contig_cap"])
def test_retries_counted_and_contigs_unchanged(monkeypatch, case):
    """Each redone piece of work adds to its phase's `retries`, and the
    contigs stay the golden oracle's."""
    kw, phase = {}, "simplify"
    if case == "walk_ladder":  # every rung overflows: the dense pass runs
        monkeypatch.setattr(graph_simplify, "run_pass_inc", functools.partial(
            graph_simplify.run_pass_inc, walk_m=(2,)))
    elif case == "kill_buffer":
        monkeypatch.setattr(graph_simplify, "_KILL_M", 1)
    elif case == "tails":
        monkeypatch.setattr(graph_simplify, "_TAIL_M", 1)
        phase = "contigs"
    elif case == "capacity":
        kw, phase = dict(capacity=256), "count"
    else:
        monkeypatch.setattr(pipeline, "emit_contigs_device",
                            functools.partial(pipeline.emit_contigs_device,
                                              contig_cap=1))
        phase = "contigs"
    contigs, events = _job(**kw)
    assert contigs == list(_want())
    ends = _ends(events)
    assert ends[phase]["retries"] > 0
    assert sum(e["retries"] for e in ends.values()) == ends[phase]["retries"]
