"""The benchmark's harness on the CPU: everything BENCHMARK.json names is
found by name, a new cell is taken with no code edit, the generator is
deterministic, and every metric reader reads what it should."""

from __future__ import annotations

import hashlib
import json
import types

import numpy as np
import pytest
import torch

from _assembly_bench_tiny import ROOT, bench_copy
from assembly_bench import fastx, gen, harness, records, trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
E2E = {m["name"] for m in BENCH["end_to_end"]}
PER_LAYER = {m["name"] for m in BENCH["per_layer"]}


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(wl):
    cell = harness.load_cell(wl["name"])
    assert (cell["config"], cell["traffic"]) == (wl["config"], wl["traffic"])
    entry = harness.load_entry(cell["entry"])
    for fn in ("prepare", "run", "collect", "cleanup"):
        assert callable(getattr(entry, fn))
    reported = {m["name"] for m in harness.cell_metrics(BENCH, wl["name"],
                                                        False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(BENCH, wl["name"], True)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    data = harness.load_config(cfg["name"])
    assert (ROOT / cfg["file"]).resolve() == (
        harness.BENCH_DIR / "configs" / f"{cfg['name']}.json").resolve()
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"]
    for key in ("genome_len", "read_len", "error_rate", "k",
                "min_coverage", "guarantees", "assumed"):
        assert key in data


@pytest.mark.parametrize("name", sorted(E2E | PER_LAYER))
def test_metric_found_by_name(name):
    assert callable(harness.load_metric(name).read)


def test_benchmark_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert E2E == {"setup_s", "bases_per_s", "peak_device_gib"}
    names = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] == "bases_per_s"
        assert set(m["workloads"]) <= set(names)
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        # four chips only where the cell runs the sharded path, one a rank
        cfg = harness.load_config(w["config"])
        sharded = harness.load_cell(w["name"])["entry"] == "multihost"
        assert w["chips"] == (cfg["ranks"] if sharded else 1)
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


# a 3 kbp circle at 2 copies a cell: it shares no k-mer with the
# chromosome, so it assembles to an isolated cycle, which has no head. At
# 40x and 0.2 % substitutions it stays one cycle; at 20 copies (400x)
# error k-mers seen twice or more branch it into some 240 contigs, and the
# ruler ranking finds heads
CIRCLE = {"replicons": [dict(name="circle", length=3000, circular=True,
                             copies=2)]}


@pytest.mark.parametrize("config,keys,reads", [
    ("tiny", {}, 20 * 20000 // 100),
    ("tinymt", CIRCLE, 20 * 20000 // 100 + 20 * 2 * 3000 // 100)],
    ids=["linear", "circular_replicon"])
def test_new_cell_taken_without_code_edit(tmp_path, config, keys, reads):
    cell = dict(entry="pipeline", coverage=20, ploidy=1, isolates=2)
    root = bench_copy(tmp_path, configs={config: keys},
                      cells={f"{config}.added": cell})
    lines = []
    out = harness.run_cell(f"{config}.added", 2**31 + 11, 0.5, False,
                           device="cpu", root=root,
                           log=lambda *a, **k: lines.append(" ".join(a)))
    res = out["result"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert {"setup_s", "bases_per_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    rec = out["record"]
    assert rec["jobs"][0]["bases"] == reads * 100
    # each isolate's reads and digest, logged once the window has closed
    cfg = harness.load_config(config, root / "assembly_bench")
    isolates = gen.make_isolates(cfg, cell, 2**31 + 11)
    assert [ln for ln in lines if ln.startswith("[isolate ")] == [
        f"[isolate {i}] reads={reads} "
        f"sha256={hashlib.sha256(iso).hexdigest()}"
        for i, iso in enumerate(isolates)]


def test_circular_replicon_takes_the_dense_cycle_path(tmp_path,
                                                      monkeypatch):
    """The circle's cycle reaches final_chain_state's dense path in every
    job: the ruler ranking returns ok False; the reference emits the
    cycle as one contig of its length + k - 1 (SEMANTICS.md section 6)."""
    from assembly_bench import reference
    from genome_tpu_torch.graph import simplify
    oks, per_job, refs = [], [], []
    rank = simplify._rank_rulers

    def spy_rank(prev_u):
        out = rank(prev_u)
        oks.append(bool(out[2]))
        return out
    monkeypatch.setattr(simplify, "_rank_rulers", spy_rank)
    assemble = reference.assemble

    def spy_assemble(*a, **k):
        refs.append(assemble(*a, **k))
        return refs[-1]
    monkeypatch.setattr(reference, "assemble", spy_assemble)

    def wrap(entry):
        def run(state, job):
            n = len(oks)
            raw = entry.run(state, job)
            per_job.append(oks[n:])
            return raw
        return types.SimpleNamespace(prepare=entry.prepare, run=run,
                                     collect=entry.collect,
                                     cleanup=entry.cleanup)

    root = bench_copy(tmp_path, configs={"tinymt": CIRCLE}, cells={
        "tinymt.circle": dict(entry="pipeline", coverage=20, ploidy=1,
                              isolates=2)})
    out = harness.run_cell("tinymt.circle", 2**31 + 11, 0.5, False,
                           device="cpu", root=root, log=lambda *a, **k: None,
                           wrap_entry=wrap)
    res = out["result"]
    assert res["correct"] and res["failed"] == 0
    # the two warm-up jobs and the window's
    assert len(per_job) == 2 + res["attempted"]
    assert all(job and not any(job) for job in per_job)
    k = harness.load_config("tinymt", root / "assembly_bench")["k"]
    assert len(refs) == 2
    for contigs in refs:
        assert [len(c) for c in contigs].count(3000 + k - 1) == 1


TINY_CFG = dict(genome_len=30000, repeat_families=[[2000, 4]],
                repeat_divergence=0.002, read_len=100, error_rate=0.002)


@pytest.mark.parametrize("ploidy", [1, 2])
def test_generator_deterministic_per_seed(ploidy):
    cell = dict(coverage=25, ploidy=ploidy, het_rate=0.002)
    seed = 2**31 + 12345
    a = gen.make_isolate(TINY_CFG, cell, seed, 0)
    b = gen.make_isolate(TINY_CFG, cell, seed, 0)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, gen.make_isolate(TINY_CFG, cell, seed, 1))
    assert not np.array_equal(a, gen.make_isolate(TINY_CFG, cell, seed + 1,
                                                  0))
    assert a.shape == (7500, 100) and a.dtype == np.uint8
    assert a.max() <= 3
    # about the stated substitution rate, on reads from both strands
    assert 0.3 < (a == 0).mean() / 0.25 < 1.7


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_stated_read_counts(wl):
    cell = harness.load_cell(wl["name"])
    cfg = harness.load_config(cell["config"])
    stated = {"ecoli_k21.fastq24": 1_113_996,
              "yeast_k31.diploid30": 2_414_265,
              "yeast_k31.haploid30": 2_414_265,
              "chr14_k31.multihost30": 26_224_615,
              "ecoli_k21.codes24": 1_113_996}
    assert gen.n_reads(cfg, cell) == stated[wl["name"]]
    assert cell.get("isolates", 2) == 2


def test_fastq_writer_read_by_the_program(tmp_path):
    from genome_tpu_torch.io import read_fastx
    codes = gen.make_isolate(TINY_CFG, dict(coverage=3, ploidy=1), 7, 0)
    fastx.write_fastq(tmp_path / "r.fastq", codes, block_rows=333)
    got = read_fastx(tmp_path / "r.fastq")
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    assert got == [row.tobytes().decode() for row in lut[codes]]


def test_fasta_reader(tmp_path):
    from genome_tpu_torch.io import write_fasta
    seqs = ["ACGT" * 50, "T", "GATTACA" * 13]
    write_fasta(tmp_path / "c.fasta", seqs)
    assert fastx.read_fasta(tmp_path / "c.fasta") == [
        (f"contig_{i}", s) for i, s in enumerate(seqs)]


def _events(read_input=None, count=0.1, build=0.02, simplify=0.3, rounds=3,
            final=0.01, emit=0.05):
    ev = []
    if read_input is not None:
        ev.append(dict(event="phase_end", phase="read_input",
                       wall_s=read_input))
    ev += [dict(event="phase_end", phase="count", wall_s=count),
           dict(event="phase_end", phase="build", wall_s=build)]
    ev += [dict(event="simplify_round", wall_s=simplify / rounds)] * rounds
    ev += [dict(event="phase_end", phase="simplify", wall_s=simplify),
           dict(event="phase_end", phase="contigs", wall_s=final + emit,
                final_s=final, emit_s=emit),
           dict(event="done")]
    return ev


def _record(cli: bool, tr=None):
    ri = (0.2, 0.3) if cli else (None, None)
    jobs = [dict(isolate=0, wall_s=1.0, bases=1000,
                 events=_events(ri[0], rounds=3)),
            dict(isolate=1, wall_s=2.0, bases=3000,
                 events=_events(ri[1], count=0.3, rounds=5, final=0.03))]
    return dict(setup_s=12.5, window_s=4.0, peak_bytes=3 * 2**30,
                jobs=jobs, launches={"compact": 4}, trace=tr)


def _trace_rows():
    return [dict(cat="gpu_memset", name="Memset (Device)", ts=0, dur=2,
                 args=dict(stream=7)),
            dict(cat="kernel", name="compact_tiles", ts=3, dur=10,
                 args=dict(stream=7)),
            dict(cat="gpu_memset", name="Memset (Device)", ts=20, dur=1,
                 args=dict(stream=7)),
            dict(cat="kernel", name="other", ts=21, dur=5,
                 args=dict(stream=7)),
            dict(cat="kernel", name="compact_tiles", ts=30, dur=8,
                 args=dict(stream=7))]


EXPECTED = {
    "setup_s": (12.5, 12.5),
    "bases_per_s": (1000.0, 1000.0),
    "job_p90_s": (1.9, 1.9),
    "peak_device_gib": (3.0, 3.0),
    "parse_ms": (250.0, None),
    "count_ms": (200.0, 200.0),
    "build_ms": (20.0, 20.0),
    "simplify_ms": (300.0, 300.0),
    "simplify_rounds": (4.0, 4.0),
    "final_ms": (20.0, 20.0),
    "emit_ms": (50.0, 50.0),
    # walls 1.0 and 2.0 less read_input + count + build + simplify + contigs
    "cli_output_ms": (1e3 * ((1.0 - 0.68) + (2.0 - 1.0)) / 2, None),
    "compact_us_per_call": (20.0 / 4, 20.0 / 4),
    "device_idle_pct": (100 * (1 - 2.0 / 4.0), 100 * (1 - 2.0 / 4.0)),
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("cli", [True, False], ids=["cli", "pipeline"])
def test_metric_reader_values(name, cli):
    tr = dict(rows=_trace_rows(), busy_s=2.0, window_s=4.0)
    got = harness.load_metric(name).read(_record(cli, tr))
    want = EXPECTED[name][0 if cli else 1]
    assert got == pytest.approx(want) if want is not None else got is None


@pytest.mark.parametrize("name", ["compact_us_per_call", "device_idle_pct"])
def test_trace_readers_silent_without_trace(name):
    assert harness.load_metric(name).read(_record(True)) is None


def _event(cat, name, ts, dur, tid=1, **args):
    return dict(cat=cat, name=name, ts=ts, dur=dur, tid=tid, args=args)


def test_trace_busy_gaps_and_rows():
    events = [
        _event("user_annotation", trace.ANNOTATION, 100, 100),
        _event("cpu_op", "aten::sort", 105, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=1),
        _event("kernel", "sortk", 112, 30, tid=9, correlation=1, stream=7),
        _event("cpu_op", "aten::nonzero", 150, 30),
        _event("cpu_op", "aten::item", 160, 5),
        _event("cuda_runtime", "cudaMemcpyAsync", 161, 2, correlation=2),
        _event("gpu_memcpy", "Memcpy DtoH", 170, 10, tid=9, correlation=2,
               stream=7),
        _event("cuda_runtime", "cudaLaunchKernel", 185, 1, correlation=3),
    ]
    rows, lost = trace.block_rows(events)
    assert [r["name"] for r in rows] == ["sortk", "Memcpy DtoH"] and lost == 1
    busy = trace.busy_intervals(rows)
    assert busy == [(112, 142), (170, 180)]
    # gaps 100-112 (midpoint 106, in aten::sort), 142-170 (156, in
    # aten::nonzero) and 180-200 (190, past every op)
    gaps = dict(trace.idle_gaps(events, busy))
    assert gaps == pytest.approx({"aten::sort": 12 / 1e6,
                                  "aten::nonzero": 28 / 1e6,
                                  "host python": 20 / 1e6})
    assert trace.device_ops(rows) == [["sortk", 30 / 1e6],
                                      ["Memcpy DtoH", 10 / 1e6]]


def test_harness_card_check_exits_without_a_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from assembly_bench import run
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_idle_gaps_named_by_phase_spans():
    events = [
        _event("user_annotation", trace.ANNOTATION, 100, 100),
        _event("cpu_op", "aten::sort", 105, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=1),
        _event("kernel", "sortk", 112, 30, tid=9, correlation=1, stream=7),
    ]
    rows, lost = trace.block_rows(events)
    prof = types.SimpleNamespace(rows=rows, lost=lost, events=events,
                                 wall_at_block=1000.0)
    # spans in time.time() seconds: a job over 90-150 us of the trace, its
    # parse over 100-120 us; the gap 142-200 (midpoint 171) is past the job
    job = (1000.0 - 10e-6, 1000.0 + 50e-6, "job, outside phases")
    parse = (1000.0, 1000.0 + 20e-6, "parse")
    got = dict(trace.summarize(prof, 1e-4, [job, parse])["idle_gaps"])
    assert got == pytest.approx({"parse: aten::sort": 12e-6,
                                 "between jobs: host python": 58e-6})


def test_record_spans_from_metrics_events():
    rec = _record(True)
    for j, t0 in zip(rec["jobs"], (10.0, 20.0)):
        j.update(t0_wall=t0, t1_wall=t0 + j["wall_s"])
        for e in j["events"]:
            e.setdefault("ts", t0 + 0.9)
    spans = records.spans(rec)
    assert (10.0, 11.0, "job, outside phases") in spans
    assert (10.9 - 0.2, 10.9, "parse") in spans
    a = 10.9 - 0.06
    assert (a, a + 0.01, "final state") in spans
    assert (a + 0.01, 10.9, "emission") in spans


def test_record_spans_name_the_dist_phases():
    """A multihost job's events (rank 0's): each dist phase is a span under
    its layer's name, the escape's replicated simplify as the sharded
    one's."""
    names = {"dist_extract": "dist extraction", "dist_count": "dist count",
             "dist_build": "dist build",
             "dist_simplify_sharded": "dist simplify",
             "dist_simplify": "dist simplify",
             "dist_final_sharded": "dist final state",
             "dist_contigs": "dist emission"}
    ev, t = [], 10.0
    for phase in names:
        t += 0.5
        ev.append(dict(event="phase_end", phase=phase, ts=t, wall_s=0.5))
    ev.append(dict(event="done"))
    rec = dict(jobs=[dict(t0_wall=10.0, t1_wall=t + 0.1, events=ev)])
    spans = records.spans(rec)
    assert spans[0] == (10.0, t + 0.1, "job, outside phases")
    assert [(b - a, n) for a, b, n in spans[1:]] == pytest.approx(
        [(0.5, n) for n in names.values()])
    assert [a for a, _, _ in spans[1:]] == pytest.approx(
        [10.0 + 0.5 * i for i in range(len(names))])


def test_compaction_bytes():
    from assembly_bench.kernel_bytes import compaction_bytes
    flags = torch.tensor([1, 0, 1, 1, 0, 0, 0, 1], dtype=torch.bool)
    vals = torch.arange(8, dtype=torch.int64)
    # 8 flag bytes; 3 kept of 4 flagged (capacity 3): 3 payload reads of 8
    # bytes, 3 slots of payload + pos written, the int64 total
    assert compaction_bytes(flags, (vals,), 3) == 8 + 24 + 3 * 16 + 8
    # in 32-byte sectors of 4 int64: the kept elements lie in the first
    assert compaction_bytes(flags, (vals,), 3, sector=32) \
        == 8 + 32 + 3 * 16 + 8
