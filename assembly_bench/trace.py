"""The `--trace 1` session: one torch.profiler session over the window,
and what the per-layer readers and the `breakdown` take from its trace.

`profiled` and `block_rows` are copies of chip_smoke.py's `_profiled` and
`_block_rows`, frozen here so that later changes to the smoke script do
not move the benchmark. torch.profiler on
the card loses the device records of a session's first calls
(scripts/torch_profiler_probe.py), so the session opens with a prologue
of device calls it does not read and a short wait, then the block. One
change: a block call without a device record is counted and reported,
not raised, since one lost record in a window of many jobs must not end
the run.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import types

PROFILE_MARGIN_S = 0.2
PROLOGUE_ROUNDS = 8  # a pinned copy, a kernel and a fill each
ANNOTATION = "_profiled block"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_DEVICE_CALLS = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset",
                 "cuLaunchKernel", "cuMemcpy", "cuMemset")
_NAME_CHARS = 120
_NAME_NOISE = ("void ", "at::native::", "(anonymous namespace)::",
               "at_cuda_detail::cub::", "at::detail::", "c10::")


@contextlib.contextmanager
def profiled(workdir: str):
    """torch.profiler (CPU and CUDA) around the block, after a prologue.
    Yields a namespace that holds, after the block, `events` (the Chrome
    trace's events), `rows` (the device records of the block's host calls,
    in time order) and `lost` (block calls with no device record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out = types.SimpleNamespace()
    host = torch.zeros(1024, dtype=torch.uint8).pin_memory()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROLOGUE_ROUNDS):
            host.to("cuda", non_blocking=True).add_(1).zero_()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        out.wall_at_block = time.time()
        with record_function(ANNOTATION):
            yield out
            torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
        t0 = time.perf_counter()
    t1 = time.perf_counter()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    t2 = time.perf_counter()
    out.trace_bytes = os.path.getsize(path)
    with open(path) as f:
        out.events = json.load(f)["traceEvents"]
    os.unlink(path)
    out.rows, out.lost = block_rows(out.events)
    out.cost_s = dict(stop=t1 - t0, export=t2 - t1,
                      read=time.perf_counter() - t2)


def block_rows(events, annotation=ANNOTATION):
    """(device records of the host calls inside the trace's `annotation`,
    in time order; the number of those calls with no device record)."""
    block = next(e for e in events if e.get("name") == annotation
                 and e.get("cat") == "user_annotation")
    device = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in DEVICE_CATS}
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e["name"].startswith(_DEVICE_CALLS)]
    inside = [e for e in calls
              if block["ts"] <= e["ts"] <= block["ts"] + block["dur"]]
    lost = sum(e["args"].get("correlation") not in device for e in inside)
    rows = sorted((device[c] for e in inside
                   if (c := e["args"].get("correlation")) in device),
                  key=lambda e: e["ts"])
    return rows, lost


def busy_intervals(rows) -> list[tuple[float, float]]:
    """The union of the device records' [start, end) in us, merged."""
    out: list[list[float]] = []
    for e in sorted(rows, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name without the namespaces that every ATen and CUB
    kernel repeats, cut to _NAME_CHARS."""
    for noise in _NAME_NOISE:
        name = name.replace(noise, "")
    return name[:_NAME_CHARS]


def device_ops(rows, top: int = 10) -> list[list]:
    """[name, seconds] of the device operations that took most time."""
    agg: dict = {}
    for e in rows:
        name = short_name(e["name"])
        agg[name] = agg.get(name, 0.0) + e["dur"] / 1e6
    return [[n, s] for n, s in sorted(agg.items(), key=lambda x: -x[1])[:top]]


def idle_gaps(events, busy, spans=(), top: int = 10) -> list[list]:
    """[label, seconds]: the device's idle time inside the block, summed by
    label, the most first. A gap's label is what the host was doing at
    its midpoint: the innermost of `spans` there ((start, end, name) in
    the trace's time, such as a job's phases), then the innermost host op
    on the block's thread ("host python" where none is)."""
    block = next(e for e in events if e.get("name") == ANNOTATION
                 and e.get("cat") == "user_annotation")
    lo, hi = block["ts"], block["ts"] + block["dur"]
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        gaps.append((at, hi))
    ops = sorted((e for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("tid") == block.get("tid")
                  and e.get("name") != ANNOTATION
                  and e["ts"] + e.get("dur", 0) >= lo and e["ts"] <= hi),
                 key=lambda e: (e["ts"], -e.get("dur", 0)))
    spans = sorted(spans)

    def end(e):
        return e["ts"] + e.get("dur", 0)

    agg: dict = {}
    stack: list = []  # the open ops at the sweep point, outermost first
    active: list = []  # the spans open at the sweep point
    i = j = 0
    for a, b in gaps:
        mid = (a + b) / 2
        while i < len(ops) and ops[i]["ts"] <= mid:
            while stack and end(stack[-1]) <= ops[i]["ts"]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and end(stack[-1]) <= mid:
            stack.pop()
        while j < len(spans) and spans[j][0] <= mid:
            active.append(spans[j])
            j += 1
        active = [sp for sp in active if sp[1] > mid]
        name = stack[-1]["name"][:_NAME_CHARS] if stack else "host python"
        if spans:
            where = min(active, key=lambda sp: sp[1] - sp[0])[2] \
                if active else "between jobs"
            name = f"{where}: {name}"
        agg[name] = agg.get(name, 0.0) + (b - a) / 1e6
    return [[n, s] for n, s in sorted(agg.items(), key=lambda x: -x[1])[:top]]


def summarize(prof_ns, window_s: float, spans=()) -> dict:
    """What the readers and the result line take from the session. `spans`
    are (start, end, name) in seconds of time.time()."""
    rows = prof_ns.rows
    busy = busy_intervals(rows)
    busy_s = sum(b - a for a, b in busy) / 1e6
    block = next(e for e in prof_ns.events if e.get("name") == ANNOTATION
                 and e.get("cat") == "user_annotation")
    shift = block["ts"] - prof_ns.wall_at_block * 1e6
    spans = [(a * 1e6 + shift, b * 1e6 + shift, n) for a, b, n in spans]
    t0 = time.perf_counter()
    gaps = idle_gaps(prof_ns.events, busy, spans)
    cost = dict(getattr(prof_ns, "cost_s", {}),
                gaps=time.perf_counter() - t0)
    return dict(rows=rows, lost=prof_ns.lost, busy_s=busy_s,
                window_s=window_s, device_ops=device_ops(rows),
                idle_gaps=gaps, cost_s=cost,
                trace_bytes=getattr(prof_ns, "trace_bytes", 0))
