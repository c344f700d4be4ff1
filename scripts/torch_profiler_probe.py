"""Does torch.profiler keep every device record of a run on the card?

Runs short profiled sessions in one long-lived process and checks each
trace's device records against its host calls, matched by correlation id:
every cudaMemcpyAsync and cudaLaunchKernel the host made inside the
session must have its device record. For each session it prints the
process age, the host calls and device records of each kind, the ones
that went missing with their host time relative to the session's start,
and the spread of (device start - host call) over the matched records (a
negative value is a device record placed before its own host call: the
profiler's device clock disagrees with its host clock).

Kinds of session, each repeated over the process's life:
  copies   5 pinned host-to-device copies of 6,553,600 bytes, each
           followed by a small kernel (CPU and CUDA activities);
  short    3 small kernels under CUDA activity only;
  pad      `copies` with 200 ms of host sleep after the profiler starts
           and before it stops;
  extract  extract_stream of the legacy bench workload (4 chunks of
           pinned packed codes and the mask), CPU and CUDA activities;
  pipeline run_pipeline on the legacy workload, with the 200 ms margins;
  dist     assemble_sharded on the legacy workload in a NCCL group of
           one rank, with the 200 ms margins.
--kinds picks them (default copies,short,pad,extract; pipeline and dist
run in a process that holds a NCCL group of one rank). The traces go to
--out (default: a new temporary directory; gzip): every trace of the
small kinds, and of pipeline and dist the first and every one that lost
a record. A lost record is printed with its host call's time from the
trace's start and the lags of the kept records within 20 ms of it.

    PYTHONPATH=. python3 scripts/torch_profiler_probe.py [--seconds 150]
        [--kinds pipeline,dist] [--out DIR]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

def _session(kind: str, host: list, x: torch.Tensor, codes=None):
    from genome_tpu_torch.params import AssemblyParams
    acts = [ProfilerActivity.CUDA] if kind == "short" else [
        ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("probe_window"):
            if kind in ("pad", "pipeline", "dist"):
                time.sleep(0.2)
            if kind == "pipeline":
                from genome_tpu_torch.assemble.pipeline import run_pipeline
                run_pipeline(codes, AssemblyParams(k=21, min_coverage=2),
                             device="cuda")
            elif kind == "dist":
                from genome_tpu_torch.dist import assemble_sharded
                assemble_sharded(codes, AssemblyParams(k=21, min_coverage=2),
                                 device="cuda")
            elif kind == "extract":
                from genome_tpu_torch.assemble.pipeline import extract_stream
                extract_stream(codes, 21, "cuda")
            elif kind == "short":
                for _ in range(3):
                    x.add_(1)
            else:
                for h in host:
                    d = h.to("cuda", non_blocking=True)
                    d.sum()
            torch.cuda.synchronize()
            if kind in ("pad", "pipeline", "dist"):
                time.sleep(0.2)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    return prof, trace


def _summary(trace: dict) -> dict:
    ev = trace["traceEvents"]
    win = next((e for e in ev if e.get("name") == "probe_window"
                and e.get("cat") == "user_annotation"), None)
    t0 = win["ts"] if win else min(e["ts"] for e in ev if "ts" in e)
    host = {}
    for e in ev:
        if e.get("cat") == "cuda_runtime" and e.get("name") in (
                "cudaMemcpyAsync", "cudaLaunchKernel", "cudaLaunchKernelExC",
            "cudaMemsetAsync"):
            host[e["args"]["correlation"]] = e
    dev = {}
    for e in ev:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev[e["args"]["correlation"]] = e
    start = next((e["ts"] for e in ev if e.get("cat") == "Trace"), t0)
    lags = sorted((h["ts"], (dev[c]["ts"] - h["ts"]) / 1e3)
                  for c, h in host.items() if c in dev)
    lag = [x for _, x in lags]
    missing = [dict(name=h["name"], at_ms=(h["ts"] - start) / 1e3,
                    bytes=h["args"].get("bytes"),
                    near_lag_ms=[round(x, 3) for t, x in lags
                                 if abs(t - h["ts"]) < 2e4][:8])
               for c, h in sorted(host.items()) if c not in dev]
    count = lambda d, cat: sum(1 for e in d.values() if e.get("cat") == cat)
    return dict(
        host_memcpy=sum(1 for h in host.values()
                        if h["name"] == "cudaMemcpyAsync"),
        host_launch=sum(1 for h in host.values()
                        if h["name"] != "cudaMemcpyAsync"),
        dev_memcpy=count(dev, "gpu_memcpy"), dev_kernel=count(dev, "kernel"),
        dev_total=sum(1 for e in ev if e.get("cat") in (
            "kernel", "gpu_memcpy", "gpu_memset")),
        missing=missing,
        lag_ms=[min(lag), max(lag)] if lag else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--kinds", default="copies,short,pad,extract")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    kinds = a.kinds.split(",")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    out = a.out or tempfile.mkdtemp(prefix="profiler_probe_")
    os.makedirs(out, exist_ok=True)
    born = time.perf_counter()
    x = torch.zeros(1 << 20, device="cuda")
    host = [torch.full((6_553_600,), i, dtype=torch.uint8).pin_memory()
            for i in range(5)]
    from genome_tpu_torch.io.benchdata import bench_workload
    codes = bench_workload(1.0)["err"]
    if "dist" in kinds or "pipeline" in kinds:
        from genome_tpu_torch.dist.mesh import init_group
        rdzv = tempfile.mkdtemp()
        init_group(0, 1, f"file://{rdzv}/rendezvous", device="cuda")
    torch.cuda.synchronize()
    print(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}; traces in {out}", flush=True)
    n = 0
    while time.perf_counter() - born < a.seconds:
        for kind in kinds:
            age = time.perf_counter() - born
            _, trace = _session(kind, host, x, codes)
            s = _summary(trace)
            if kind not in ("pipeline", "dist") or s["missing"] or n < 2:
                with gzip.open(os.path.join(out, f"{n:03d}_{kind}.json.gz"),
                               "wt") as f:
                    json.dump(trace, f)
            print(f"[probe] #{n:03d} age={age:7.2f} s {kind:6s} "
                  f"{json.dumps(s)}", flush=True)
            n += 1
        # GPU work between sessions, as a smoke's phases put there
        y = torch.randn(1 << 24, device="cuda")
        for _ in range(50):
            y = torch.sort(y).values
        torch.cuda.synchronize()
        time.sleep(1.0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
