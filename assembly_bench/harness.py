"""One run of one cell: make the isolates from the seed, warm up, run a
closed loop of assembly jobs for `seconds`, then check every job's
contigs against the plain reference and compute the cell's metrics.

Everything that belongs to one cell, configuration, entry or metric is a
file of its own, found by name: `cells/<cell>.json` (the traffic mix),
`configs/<config>.json`, `entries/<entry>.py` and `metrics/<metric>.py`.
BENCHMARK.json, at the root of the checkout, names the cells and which
metrics each reports. run.py is the command line; this module makes no
check for a card, so the tests drive it on the CPU.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import importlib.util
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from assembly_bench import gen, records, reference
from assembly_bench import trace as trace_mod

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "genome_tpu")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"assembly_bench_{path.parent.name}_{path.stem.replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path) -> dict:
    return _load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _load_json(bench_dir / "cells" / f"{name}.json")


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _load_json(bench_dir / "configs" / f"{name}.json")


def load_entry(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir / "entries" / f"{name}.py")


def load_metric(name: str, bench_dir: Path = BENCH_DIR):
    return _module(bench_dir / "metrics" / f"{name}.py")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: the end-to-end ones without
    trace, the per-layer ones with it."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def digest(contigs) -> str | None:
    if contigs is None:
        return None
    h = hashlib.sha256()
    for c in contigs:
        h.update(c.encode("ascii"))
        h.update(b"\n")
    return h.hexdigest()


def _launch_total() -> dict:
    from genome_tpu_torch.kernels import compact
    return {"compact": sum(compact.LAUNCHES.values())}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path | None = None,
             t_start: float | None = None, log=print,
             wrap_entry=None) -> dict:
    """One run. Returns dict(result=<the result line's object>,
    checks=<each compared number with its limit>, record=<the record>).

    wrap_entry, for the tests and control.py: a function (entry module) ->
    an object whose prepare/run/collect/cleanup stand in for the entry's."""
    t_start = time.perf_counter() if t_start is None else t_start
    root = Path(root) if root else BENCH_DIR.parent
    bench_dir = root / BENCH_DIR.name
    bench = benchmark(root)
    wl = workload(bench, cell_name)
    cell = load_cell(cell_name, bench_dir)
    cfg = load_config(wl["config"], bench_dir)
    entry = load_entry(cell["entry"], bench_dir)
    if wrap_entry is not None:
        entry = wrap_entry(entry)
    metrics = cell_metrics(bench, cell_name, trace)
    readers = {m["name"]: load_metric(m["name"], bench_dir) for m in metrics}

    workdir = tempfile.mkdtemp(prefix="assembly_bench_")
    try:
        return _run(wl, cell, cfg, entry, metrics, readers, seed,
                    seconds, trace, device, workdir, t_start, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _run(wl, cell, cfg, entry, metrics, readers, seed, seconds,
         trace, device, workdir, t_start, log) -> dict:
    from genome_tpu_torch.kernels import compact

    # ---- set-up: isolates, the entry's inputs, one warm-up job each ----
    isolates = gen.make_isolates(cfg, cell, seed, device)
    bases = [int(iso.size) for iso in isolates]
    states = [entry.prepare(iso, cfg, workdir, device, f"isolate{i}")
              for i, iso in enumerate(isolates)]
    for i, st in enumerate(states):
        entry.collect(st, entry.run(st, -1 - i))
    _sync(device)
    gc.collect()

    # ---- the window: a closed loop, isolates alternating ----
    raws, jobs, failed = [], [], 0
    with contextlib.ExitStack() as stack:
        prof = stack.enter_context(trace_mod.profiled(workdir)) \
            if trace else None
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        compact.reset_launches()
        t_open = time.perf_counter()
        setup_s = t_open - t_start
        t_close = t_open
        n = 0
        while n == 0 or time.perf_counter() - t_open < seconds:
            iso = n % len(states)
            t0, w0 = time.perf_counter(), time.time()
            try:
                raw = entry.run(states[iso], n)
            except Exception as e:  # a failed job is counted, the loop goes on
                log(f"[job {n}] failed: {type(e).__name__}: {e}",
                    file=sys.stderr)
                raw = None
                failed += 1
            t_close = time.perf_counter()
            raws.append(raw)
            jobs.append(dict(isolate=iso, wall_s=t_close - t0,
                             bases=bases[iso], ok=raw is not None,
                             t0_wall=w0, t1_wall=w0 + (t_close - t0)))
            n += 1
        window_s = t_close - t_open
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        launches = _launch_total()

    # the isolates, so that two commits' can be compared from their runs'
    # logs (hashed here, not in the set-up that setup_s times)
    for i, iso in enumerate(isolates):
        log(f"[isolate {i}] reads={iso.shape[0]} "
            f"sha256={hashlib.sha256(iso).hexdigest()}", file=sys.stderr)

    # ---- outputs, then the program's state freed ----
    got = []
    for job, raw in zip(jobs, raws):
        contigs, events = (None, []) if raw is None else \
            entry.collect(states[job["isolate"]], raw)
        job["events"] = events
        got.append(digest(contigs))
    for st in states:
        entry.cleanup(st)
    del states, raws
    rec = dict(setup_s=setup_s, window_s=window_s, peak_bytes=peak,
               jobs=jobs, launches=launches, trace=None)
    if trace:
        tsum = rec["trace"] = trace_mod.summarize(prof, window_s,
                                                  records.spans(rec))
        log(f"[trace] {len(tsum['rows'])} device records, {tsum['lost']} "
            f"block calls without one; busy {tsum['busy_s']:.6f} s of "
            f"{window_s:.6f} s; {len(prof.events)} events, "
            f"{tsum['trace_bytes']} bytes; seconds spent: " + " ".join(
                f"{k}={v:.1f}" for k, v in tsum["cost_s"].items()),
            file=sys.stderr)
        del prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    # ---- the reference, once per isolate ----
    t_ref = time.perf_counter()
    want = [digest(reference.assemble(
                iso, cfg["k"], cfg["min_coverage"], cfg["tip_len"],
                cfg["bubble_len"], cfg["max_rounds"], device=device))
            for iso in isolates]
    _sync(device)
    ref_s = time.perf_counter() - t_ref
    wrong = sum(1 for job, d in zip(jobs, got)
                if job["ok"] and d != want[job["isolate"]])

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    walls = sorted(j["wall_s"] for j in jobs)
    log(f"[window] {len(jobs)} jobs in {window_s:.6f} s, median job "
        f"{walls[len(walls) // 2]:.6f} s, reference {ref_s:.3f} s",
        file=sys.stderr)
    log("[window] job walls in order: " + " ".join(
        f"{j['wall_s']:.4f}" for j in jobs), file=sys.stderr)
    phases = {p: records.phase_ms(rec, p) for p in records.PHASES}
    phases["final"] = records.phase_ms(rec, "contigs", "final_s")
    phases["emit"] = records.phase_ms(rec, "contigs", "emit_s")
    log("[window] mean phase ms a job: " + " ".join(
        f"{p}={v:.1f}" for p, v in phases.items() if v is not None),
        file=sys.stderr)
    for job in sorted(jobs, key=lambda j: -j["wall_s"])[:3]:
        log(f"[window] a slowest job: {job['wall_s']:.4f} s, phases "
            + " ".join(f"{e['phase']}={e['wall_s']}" for e in job["events"]
                       if e.get("event") == "phase_end"), file=sys.stderr)

    checks = {"jobs_wrong": {"value": wrong, "limit": 0},
              "jobs_failed": {"value": failed, "limit": 0}}
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": torch.cuda.get_device_name(0)
                if device == "cuda" else device,
                "count": wl["chips"], "memory_peak_bytes": peak}
    tsum = rec["trace"]
    if tsum is not None:
        dev_info["busy_s"] = tsum["busy_s"]
        dev_info["window_s"] = tsum["window_s"]
    result = {"correct": wrong == 0 and failed == 0 and len(jobs) > 0,
              "attempted": len(jobs), "failed": failed,
              "metrics": values, "device": dev_info}
    if tsum is not None:
        result["breakdown"] = {"device_ops": tsum["device_ops"],
                               "idle_gaps": tsum["idle_gaps"]}
    result["checks"] = checks
    return dict(result=result, checks=checks, record=rec)
