#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (genome_tpu_torch).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero and prints no result line):
  1. device and build: the card's name and power limit, the device count,
     and the nvcc build of every kernel from kernels/csrc (with its
     -Xptxas -v report);
  2. every kernel against its plain PyTorch version on the card, exactly,
     at the main path's shapes and at edge cases, each shape timed with
     CUDA events beside its bandwidth bound, the plain version and one
     library call that computes the same function (`library_ms`; the port
     never calls it);
  3. end to end: run_pipeline on the E. coli-scale benchmark workload
     (4.6 Mbp, 100 bp reads, 24x, k = 21), legacy then with planted
     repeats; the contig SHAs must equal the golden oracle's cached in
     bench_golden_cache.json, and every compaction call site must have
     launched the kernel (except `tails`, which runs only when no cycle
     survives simplification).
The last two lines are a {"kernels": [...]} summary and
{"ok": true, "device": {...}}. Imports nothing of JAX or genome_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
REPEATS = 20


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = REPEATS) -> float:
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bound_bytes(flags, arrays, capacity, sector: int = 0) -> int:
    """Bytes the function must move: the flags read once, each payload
    read only where flagged and kept (the kernel loads nothing else), each
    output slot written once (payloads + int64 pos) and the int64 total.
    sector > 0 counts payload reads in whole `sector`-byte sectors touched
    instead of elements."""
    import torch
    kf = flags & (torch.cumsum(flags, 0) <= capacity)
    kept = int(kf.sum())
    reads = 0
    for a in arrays:
        g = sector // a.element_size() if sector else 1
        pad = torch.zeros(-kf.numel() % g, dtype=torch.bool, device=kf.device)
        reads += int(torch.cat([kf, pad]).view(-1, g).any(1).sum()) \
            * a.element_size() * g
    return flags.numel() + reads \
        + kept * (sum(a.element_size() for a in arrays) + 8) + 8


def _compare(flags, arrays, capacity):
    """Kernel vs plain version on the card; returns (max_abs_err, total)."""
    import torch
    from genome_tpu_torch.kernels.compact import (compact_flagged,
                                                  compact_flagged_ref)
    outs, pos, total, ovf = compact_flagged(flags, arrays, capacity)
    routs, rpos, rtotal, rovf = compact_flagged_ref(flags, arrays, capacity)
    torch.cuda.synchronize()
    if int(total) != int(rtotal) or bool(ovf) != bool(rovf):
        raise AssertionError(f"total/overflow {int(total)}/{bool(ovf)} != "
                             f"{int(rtotal)}/{bool(rovf)} at n={flags.numel()}")
    m = min(int(rtotal), capacity)
    err = 0
    for a, b in zip(outs + (pos,), routs + (rpos,)):
        if m:
            err = max(err, int((a[:m].to(torch.int64)
                                - b[:m].to(torch.int64)).abs().max()))
    if err:
        raise AssertionError(f"kernel != plain version (max abs err {err})")
    return float(err), int(rtotal)


def _rand(n, p, dtypes, gen):
    import torch
    flags = torch.rand(n, device="cuda", generator=gen) < p
    arrays = tuple(torch.randint(-2**31, 2**31 - 1, (n,), dtype=dt,
                                 device="cuda", generator=gen)
                   for dt in dtypes)
    return flags, arrays


def phase_kernels(shapes, gen) -> list[dict]:
    """Kernel vs plain version at edge cases and at the main path's shapes
    (`shapes`: (site, make_inputs, capacity)), each shape timed."""
    import torch
    from genome_tpu_torch.kernels.compact import (compact_flagged,
                                                  compact_flagged_ref)

    i32, i64 = torch.int32, torch.int64
    edge = [(0, .5, (i64,), 16), (1, 1., (i32,), 1), (1025, .5, (i64, i32),
            2048), (1025, 0., (i32,), 2048), (1025, 1., (i32,), 2048),
            (100_000, .5, (i64,), 1000), (12_305, .3, (i32,) * 6, 50_000)]
    for n, p, dts, cap in edge:
        _compare(*_rand(n, p, dts, gen), cap)
    print(f"[kernels] {len(edge)} edge cases equal the plain version "
          "(n = 0, 1, 1025; none, all, overflow; 6 payloads)", flush=True)

    rows = []
    for site, make_inputs, cap in shapes:
        flags, arrays = make_inputs()
        n = flags.numel()
        err, total = _compare(flags, arrays, cap)
        kept = min(total, cap)
        bound = _bound_bytes(flags, arrays, cap) / HBM_BYTES_PER_S * 1e3
        sector_bound = (_bound_bytes(flags, arrays, cap, sector=32)
                        / HBM_BYTES_PER_S * 1e3)
        ms = _time_ms(lambda: compact_flagged(flags, arrays, cap))
        plain = _time_ms(lambda: compact_flagged_ref(flags, arrays, cap))

        def library():
            idx = flags.nonzero()
            return [a[flags] for a in arrays], idx
        lib = _time_ms(library)
        row = dict(site=site, n=n, payload_bytes=[
                       a.element_size() for a in arrays],
                   capacity=cap, total=total, max_abs_err=err, ms=ms,
                   plain_ms=plain, bound_ms=bound, bound_by="bytes",
                   sector_bound_ms=sector_bound, library_ms=lib)
        rows.append(row)
        print(f"[kernels] {site:13s} n={n:>10d} cap={cap:>9d} "
              f"kept={kept:>9d} kernel={ms:8.3f} ms plain={plain:8.3f} ms "
              f"bound={bound:7.4f} ms (32 B sectors {sector_bound:7.4f} ms) "
              f"library={lib:8.3f} ms",
              flush=True)
        del flags, arrays
    return rows


def phase_profile(w, params, wall_s: float) -> None:
    """One more legacy run under torch.profiler: the device time by kernel,
    and the idle share against `wall_s`, the same run's unprofiled wall
    (the profiler's own start-up inflates the profiled wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from genome_tpu_torch.assemble.pipeline import run_pipeline
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        run_pipeline(w["err"], params, capacity=w["capacity"], device="cuda")
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages()  # kernel rows only: no double count
          if str(e.device_type).endswith("CUDA")
          and e.self_device_time_total > 0]
    ev.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    print(f"[profile legacy] device busy={busy_ms:.1f} ms; unprofiled wall="
          f"{wall_s * 1e3:.1f} ms idle_share={1 - busy_ms / (wall_s * 1e3):.3f}"
          f" (profiled wall {wall_ms:.1f} ms)", flush=True)
    for e in ev[:12]:
        print(f"[profile legacy]   {e.self_device_time_total / 1e3:8.2f} ms "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)


def phase_e2e(name, w, params, golden) -> dict:
    import torch
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.assemble.pipeline import run_pipeline
    from genome_tpu_torch.io.benchdata import contigs_sha, workload_key
    from genome_tpu_torch.kernels import compact

    key = workload_key(w, params.params_hash())
    want = golden.get(key)
    if want is None:
        raise AssertionError(f"{name}: no golden SHA cached for {key}")
    m = Metrics(quiet=True)
    torch.cuda.reset_peak_memory_stats()
    compact.reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(w["err"], params, capacity=w["capacity"], metrics=m,
                       device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(compact.LAUNCHES)
    sha = contigs_sha(res["contigs"])
    phases = {e["phase"]: e for e in m.events if e["event"] == "phase_end"}
    rounds = sum(e["event"] == "simplify_round" for e in m.events)
    print(f"[e2e {name}] wall={wall:.3f} s "
          + " ".join(f"{p}={e['wall_s']:.3f}s" for p, e in phases.items())
          + f" final={phases['contigs']['final_s']:.3f}s "
          f"emit={phases['contigs']['emit_s']:.3f}s rounds={rounds}",
          flush=True)
    print(f"[e2e {name}] windows={res['stats']['n_windows']} "
          f"unique={res['stats']['n_unique']} alive={res['stats']['n_alive']}"
          f" contigs={len(res['contigs'])} "
          f"bp={sum(map(len, res['contigs']))} count_kmers_per_s="
          f"{phases['count']['kmers_per_s']} peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    print(f"[e2e {name}] launches={json.dumps(launches, sort_keys=True)}",
          flush=True)
    print(f"[e2e {name}] sha={sha} golden={want}", flush=True)
    if sha != want:
        raise AssertionError(f"{name}: contig SHA {sha} != golden {want}")
    missing = [s for s in compact.SITES
               if s != "tails" and launches.get(s, 0) == 0]
    if missing:
        raise AssertionError(f"{name}: no kernel launch at {missing}")
    return dict(wall_s=wall, launches=launches, sha=sha,
                phases={p: e["wall_s"] for p, e in phases.items()})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from genome_tpu_torch.io.benchdata import bench_workload
    from genome_tpu_torch.kernels import compact, cubuild
    from genome_tpu_torch.params import AssemblyParams

    # ---- phase 1: device and build ----
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    built = cubuild.build()
    print(f"[build] {built} total {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---- phase 2: kernel vs plain version at the main path's shapes ----
    from genome_tpu_torch.assemble.pipeline import count_reads, extract_stream
    params = AssemblyParams(k=21, min_coverage=2)
    legacy = bench_workload(1.0)
    cap = legacy["capacity"]
    n_unique = count_reads(legacy["err"], params, cap,
                           device="cuda")["n_unique_host"]
    step = max(256, 1 << max(0, n_unique.bit_length() - 6))
    cap2 = -(-n_unique // step) * step
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    i32, i64 = torch.int32, torch.int64
    n_runs = []

    def count_heads():  # the main path's own input: run heads of the
        # sorted legacy window stream, carrying the sorted keys
        s = torch.sort(extract_stream(legacy["err"], params.k, "cuda")).values
        first = torch.ones(s.numel(), dtype=torch.bool, device="cuda")
        first[1:] = s[1:] != s[:-1]
        n_runs.append(int(first.sum()))
        return first, (s,)

    shapes = [  # (site, inputs, capacity); densities follow the legacy run
        ("count_heads", count_heads, cap),
        ("count_filter", lambda: _rand(cap, n_unique / n_runs[0], (i64, i32),
                                       gen), cap),
        ("build", lambda: _rand(4 * cap2, 0.5, (i32,) * 5, gen), 2 * cap2),
        ("compact_ids", lambda: _rand(2 * cap2, 0.01, (), gen), 1 << 18),
    ]
    rows = phase_kernels(shapes, gen)

    # ---- phase 3: end to end, golden SHA parity ----
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench_golden_cache.json")) as f:
        golden = json.load(f)
    phase_e2e("legacy (warm-up)", legacy, params, golden)
    e2e = {"legacy": phase_e2e("legacy", legacy, params, golden)}
    phase_profile(legacy, params, e2e["legacy"]["wall_s"])
    del legacy
    e2e["repeats"] = phase_e2e("repeats", bench_workload(1.0, repeats=True),
                               params, golden)
    launches = {s: sum(r["launches"].get(s, 0) for r in e2e.values())
                for s in compact.SITES}
    print(f"[e2e] launches per site, legacy + repeats: {json.dumps(launches)}",
          flush=True)

    head = rows[0]
    summary = {"kernels": [{
        "name": "compact_flagged", "route": "cuda",
        "source": "genome_tpu_torch/kernels/csrc/compact.cu",
        "replaces": "genome_tpu/kernels/compact.py:177",
        # wrapper calls on the main path; each is three __global__ launches
        "launches": sum(launches.values()), "global_launches_per_call": 3,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "matched_plain": True,
        "sites": launches, "shapes": rows}]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
