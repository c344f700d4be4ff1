#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (genome_tpu_torch).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases (any failure exits non-zero and prints no result line):
  1. device and build: the card's name and power limit, the device count,
     and the nvcc build of every kernel from kernels/csrc, one nvcc per
     source, all started together (with each -Xptxas -v report), beside
     the g++ build of the native FASTA/FASTQ parser (io/native); then,
     before any torch.profiler session, the final state's ruler ranking
     (graph/simplify.py::_rank_rulers) on the legacy workload's final
     links (below) equal to a plain pointer doubling kept here
     (_plain_rank, with x[i] and with index_select gathers), the three
     timed in turns, with the ruler phases' rounds;
  2. the code matrix's packed upload (legacy matrix, and its real rows
     with no mask): host packing into pinned tensors cold and warm,
     extract_stream first and warm and in chunks, against the uint8 path
     (pageable copy), copies timed with CUDA events, the profiler's
     host-to-device copies (kind, bytes, time); keys equal the uint8
     path's; the extraction kernel (csrc/extract.cu) against its plain
     version at edge cases and timed at the count's two chunk shapes
     (phase_extract); then every kernel against its plain PyTorch version on the
     card, exactly, at the main path's shapes and at edge cases, each shape timed with
     CUDA events beside its bound, the plain version and one library call
     that computes the same function (`library_ms`; the port never calls
     it): compact_flagged at its four sites and at edge cases (views at
     offsets 1, 3 and 8, n one past a tile and one past a 16-flag vector,
     a capacity cut mid-tile, every flag set at 2^23), one call at
     count_heads and one at compact_ids split by kernel (torch.profiler),
     and its host time per call at compact_ids (1000 calls, no sync);
     sort_blocks and merge_blocks
     at every block size 2^8 ... 2^17 (one int64 key), == TILE, > TILE,
     one block, two keys with payloads, two int64 keys with two payloads,
     three arrays, all-equal keys, heavy ties, INT64_MAX rows, and at the
     count site (the legacy window stream, 1350 blocks of 65536), with one
     call of each split by __global__ launch (torch.profiler);
     sort_pairs_merge whole against torch.sort on that stream;
     digit_histogram and partition_by_bucket on their own path over the
     same stream (the
     (10, 32) histogram sizes a 1025-way partition of (top word, low
     word), the sentinels in the last bucket), then at edge cases (n = 0,
     one bucket, B = 1, out-of-range bids, overflow, int64 payloads,
     nbits 16, sentinels at bit 63; for the histogram also hot bins,
     14 and 15 bits, and the pair cluster (16 bits) at n = 1, 31, 33,
     misaligned and with a partial last pair; for the partition also hundreds of tiles at
     B = 2, 1025 and 4096 with buckets empty in every other tile, a
     one-bucket tail, n a tile multiple -1 and +1, views at offset 1, a
     cap reached mid-tile) and the histogram at (10, 32), (8, 0), (8, 56),
     (13, 29), (16, 26), (10, 32) on the sorted stream and on a hot one
     (90 % of the keys one key); one histogram call at (10, 32) and one
     at (16, 26), and one partition call, split by kernel (torch.profiler:
     each one memset and one __global__ launch); the histogram's host
     time per call (16,384 keys, 1000 calls, no sync);
  3. end to end on the E. coli-scale benchmark workload (4.6 Mbp, 100 bp
     reads, 24x, k = 21), the contig SHAs equal to the golden oracle's
     cached in bench_golden_cache.json:
     - run_pipeline, legacy then with planted repeats; every compaction
       call site must have launched the kernel (except `tails`, which runs
       only when no cycle survives simplification);
     - the sorter path: count_kmers_device(sorter=sort_pairs_merge) equal
       to the default sorter's table, saved as the count checkpoint and
       resumed by run_pipeline; sort_blocks launched once and merge_blocks
       once per merge level;
     - run_pipeline(counter="bucket") on both workloads and
       run_pipeline(counter="hashtable") on legacy;
     - native ingest: the legacy reads written as FASTQ and assembled by
       the CLI (cli.main, --io native) three times: the walls, every
       compaction site launched, and pinned host-to-device copies of
       exactly the packed codes (no mask, no pageable copy of 1 MiB or
       more);
  4. the hash-sharded path (genome_tpu_torch/dist) on a NCCL group of one
     rank: sharded_count of the legacy window stream equal to
     count_kmers_device's table (compact_flagged launched at count_heads
     and count_filter), the count exchange's all_to_all_single timed with
     CUDA events (at P = 1 a copy on the card), and assemble_sharded on
     legacy and repeats with the replicated simplify
     (sharded_simplify=False): a warm-up that keeps compact_flagged's
     inputs at each of its sites, each held against the plain version and
     timed at the path's own shapes (the count at the routed bucket length
     and capacity 2^27, the simplify on the gathered graph), then a timed
     run (golden SHAs, phase walls, peak device bytes, the exchange
     ledger, and a launch at every compaction site of the path), one
     profiled run; then the same with the sharded simplify passes (the
     default, `[dist sharded …]`, sharded end to end): compact_flagged
     held and timed at its dist_kills, dist_bubble_cands,
     dist_emit_blocks and dist_emit_heads inputs; the timed run's JAX
     phase list (dist_simplify_sharded, dist_final_sharded,
     dist_contigs; no dist_simplify) and no fallback event; the walls of
     the passes, the final state and the emission; the passes run and
     the slack rung from the ledger; the fast final's rounds (p1, p2);
     the dist_final_fast and dist_emit ledger entries; and one profiled
     run: the device time and idle share of the passes, the final state
     and the emission, each alone; last `[dist sharded circular]`, the
     final state's ladder: a 200,000 bp circular genome (100 bp
     error-free reads, 30x, k = 21) whose fast final falls back to the
     exact one, its one contig equal to assemble_device's;
  5. the multi-process entry (dist/multihost.py, dist/launch.py) at
     P = 1 (`[dist multihost …]`): assemble_multihost on a NCCL group of
     one rank joined by initialize, on the legacy code matrix (a warm-up
     that holds compact_flagged against its plain version at its six
     sites' inputs, a timed run: golden SHA, JAX's phase_times keys, a
     launch at every site, the phase walls beside `[dist sharded
     legacy]`'s e2e, peak bytes; a run with out_path: the FASTA's SHA, no
     shard file left); then `python -m genome_tpu_torch.dist.launch` on
     the legacy reads as FASTQ with --bench over a tcp rendezvous on
     127.0.0.1 (golden SHA, the bench record); then a crash after
     dist_build (GENOME_TPU_CRASH_AFTER, rc 7) and a --resume launch on a
     500,000 bp genome (100 bp reads, 0.5 % errors, 30x): the count and
     build shards reused, the contigs equal to run_pipeline's;
  6. every fallback branch that CPU tests alone reached before
     (`[branch …]`), on a 100,000 bp genome (100 bp reads, 1 % errors,
     30x) and a 100,000 bp circular one (error-free, 30x), each case's
     contigs equal to the port's own golden oracle (genome_tpu_torch.
     golden) and its branch proved taken from the logged events or
     counters, with the launch counters set to 0 just before it and read
     just after: run_pipeline's count capacity retry, the streaming merge,
     the walk ladder's second rung and its dense fallback (walk_m forced
     small, then empty), the kill and tail buffer overflows (_KILL_M and
     _TAIL_M lowered, then restored; compact_flagged held against its
     plain version at those overflowing calls), the cycle fallback; on a
     one-rank NCCL group _KILL_MD = 2, _bub_mc tiny on the first rung and
     then on every rung (the replicated fallback), the emission's
     overflow fallback and assemble_multihost's replicated escape; the
     CLI's --backend golden FASTA equal to the device backend's, byte for
     byte; and build_graph_join and build_graph_bsearch equal to
     build_graph_kjoin on legacy's count table.
Every profiled block runs under _profiled, which keeps it away from the
ends of its profiler session and fails when the trace lacks a device
record of a launch, copy or memset.
The last two lines are a {"kernels": [...]} summary and
{"ok": true, "device": {...}}. Imports nothing of JAX or genome_tpu.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# the data sheet has no integer compare rate; its nearest row, float32
# outside the tensor cores, taken as one compare-exchange per operation
OPS_PER_S = 67e12
REPEATS = 20
BLOCK = 65536  # sort_pairs_merge's default block
CHUNKS = (1 << 21, 1 << 19, 1 << 18, 1 << 17)  # extract_stream chunk_rows
# torch.profiler on the card loses the device records of a session's
# first calls (scripts/torch_profiler_probe.py and this script's runs,
# H100 80GB HBM3, 700 W): 9 of 234 sessions that did not wait lost
# records of work done in their first 11 ms, and in this script's
# process, from the dist phase on, every session lost the records of its
# first three calls, however long it waited. So _profiled opens each session
# with a prologue of device calls whose records it does not need, waits
# _PROFILE_MARGIN_S, runs the block, waits again, and takes only the
# block's calls: each must have its device record in the trace.
_PROFILE_MARGIN_S = 0.2
_PROLOGUE_ROUNDS = 8  # a pinned copy, a kernel and a fill each
_DEVICE_CALLS = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset",
                 "cuLaunchKernel", "cuMemcpy", "cuMemset")


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


def _rand(n, p, dtypes, gen, offset: int = 0):
    """Random flags and payloads; with offset > 0 each is a view that
    starts `offset` elements into its storage."""
    import torch
    flags = (torch.rand(n + offset, device="cuda", generator=gen) < p)[offset:]
    arrays = tuple(torch.randint(-2**31, 2**31 - 1, (n + offset,), dtype=dt,
                                 device="cuda", generator=gen)[offset:]
                   for dt in dtypes)
    return flags, arrays


def _host_us(fn, calls: int = 1000) -> float:
    """Host time per call of `fn` in microseconds: perf_counter over
    `calls` calls with no sync between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _build_native() -> float:
    """Seconds to build and load the native parser's library."""
    from genome_tpu_torch.io.native import cio
    t0 = time.perf_counter()
    cio.load()
    return time.perf_counter() - t0


@contextlib.contextmanager
def _profiled(label):
    """torch.profiler (CPU and CUDA activities) around the block, after a
    prologue (see _PROFILE_MARGIN_S). Yields a namespace that holds, after
    the block, `prof` and `rows`: the device records (kernels, copies,
    memsets) of the block's own host calls, in time order, each a dict of
    name, cat, dur (us) and args. Raises if one of those calls has no
    device record."""
    import types
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    out = types.SimpleNamespace()
    host = torch.zeros(1024, dtype=torch.uint8).pin_memory()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(_PROLOGUE_ROUNDS):
            host.to("cuda", non_blocking=True).add_(1).zero_()
        torch.cuda.synchronize()
        time.sleep(_PROFILE_MARGIN_S)
        with record_function("_profiled block"):
            yield out
            torch.cuda.synchronize()
        time.sleep(_PROFILE_MARGIN_S)
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    out.prof = prof
    out.events = events
    out.rows = _block_rows(label, events)


def _block_rows(label, events, annotation="_profiled block") -> list[dict]:
    """The device records of the host calls inside the trace's
    `annotation` (a record_function), in time order; raises if one has
    none."""
    block = next(e for e in events if e.get("name") == annotation
                 and e.get("cat") == "user_annotation")
    device = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e["name"].startswith(_DEVICE_CALLS)]
    inside = [e for e in calls
              if block["ts"] <= e["ts"] <= block["ts"] + block["dur"]]
    lost = [f"{e['name']} at {(e['ts'] - block['ts']) / 1e3:.3f} ms"
            for e in inside if e["args"].get("correlation") not in device]
    before = [e for e in calls if e["ts"] < block["ts"]]
    lost_before = sum(e["args"].get("correlation") not in device
                      for e in before)
    print(f"[{label}] profiler: {len(inside)} launches, copies and memsets "
          f"in the block, {len(lost)} without a device record; the "
          f"prologue's {len(before)} lost {lost_before}", flush=True)
    if lost:
        raise AssertionError(f"[{label}] the profiler's trace lacks the "
                             f"device record of {len(lost)} of the block's "
                             f"host calls (time from its start): {lost[:8]}")
    return sorted((device[c] for e in inside
                   if (c := e["args"].get("correlation")) in device),
                  key=lambda e: e["ts"])


def _by_name(rows) -> list[tuple[str, float, int]]:
    """(name, device ms, records) of each name in `rows`, the most device
    time first."""
    agg: dict = {}
    for e in rows:
        ms, n = agg.get(e["name"], (0.0, 0))
        agg[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in agg.items()),
                  key=lambda x: -x[1])


def _htod_rows(rows) -> list[dict]:
    """Every host-to-device copy of a profiled block (`rows` of
    _profiled): kind (Pinned or Pageable), bytes and device time."""
    out = []
    for e in rows:
        name = e["name"]
        if e["cat"] == "gpu_memcpy" and "HtoD" in name:
            kind = next((k for k in ("Pinned", "Pageable") if k in name), name)
            out.append(dict(kind=kind, bytes=int(e["args"]["bytes"]),
                            ms=e["dur"] / 1e3))
    return out


def _print_htod(label, rows) -> None:
    big = [r for r in rows if r["bytes"] >= 1 << 20]
    small = [r for r in rows if r["bytes"] < 1 << 20]
    print(f"[{label}] Memcpy HtoD: " + "; ".join(
        f"{r['kind']} {r['bytes']} B {r['ms']:.4f} ms" for r in big)
        + f"; {len(small)} more under 1 MiB ({sum(r['bytes'] for r in small)}"
        f" B, {sum(r['ms'] for r in small):.4f} ms)", flush=True)


def _wall(fn) -> float:
    """Host seconds of `fn`, between two device syncs."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_upload(w, k) -> dict:
    """The code matrix's way to the card, before anything else in the
    process allocates pinned memory: the legacy matrix (its padding rows
    are code 4, so the mask goes too) and its real rows (no N: no mask).
    For each: the host packing into pinned tensors, cold (the process's
    first pinned allocation) apart from warm; extract_stream, first call
    apart from warm ones, in chunks of each of CHUNKS rows, and the uint8
    path (a pageable copy of the codes, no packing); the copies of packed
    and mask and the pageable uint8 copy, timed with CUDA events; one warm
    call's host-to-device copies from the profiler. The keys must equal
    the uint8 path's."""
    import torch
    from genome_tpu_torch.assemble.pipeline import extract_stream
    from genome_tpu_torch.kernels.extract import (extract_canonical_kmers,
                                                  pack_codes_host)
    torch.zeros(1, device="cuda")  # the context, outside the cold calls
    res = {}
    for label, codes in (("legacy", w["err"]),
                         ("real rows", w["err"][: w["num_reads"]])):
        r = res[label] = dict(rows=codes.shape[0], uint8_bytes=codes.nbytes)
        if len(res) == 1:
            r["pack_cold_s"] = _wall(lambda: pack_codes_host(
                codes, pin_memory=True))
        r["pack_warm_s"] = [_wall(lambda: pack_codes_host(
            codes, pin_memory=True)) for _ in range(3)]
        if len(res) == 1:
            r["extract_first_s"] = _wall(lambda: extract_stream(codes, k,
                                                                "cuda"))
        r["extract_warm_s"] = [_wall(lambda: extract_stream(codes, k, "cuda"))
                               for _ in range(3)]
        r["uint8_path_s"] = [_wall(lambda: extract_canonical_kmers(
            torch.from_numpy(codes).to("cuda"), k)) for _ in range(3)]
        for c in CHUNKS:
            r[f"extract_chunk_{c}_s"] = [_wall(lambda: extract_stream(
                codes, k, "cuda", chunk_rows=c)) for _ in range(3)]
        keys = extract_stream(codes, k, "cuda")
        plain = extract_canonical_kmers(torch.from_numpy(codes).to("cuda"), k)
        if not torch.equal(keys, plain) or not torch.equal(
                extract_stream(codes, k, "cuda", chunk_rows=1 << 17), plain):
            raise AssertionError(f"upload {label}: packed keys != uint8 path")
        del keys, plain
        packed, invalid, has_invalid = pack_codes_host(codes, pin_memory=True)
        r.update(packed_bytes=packed.numel(), has_invalid=has_invalid,
                 mask_bytes=invalid.numel() if has_invalid else 0)

        def copies():
            packed.to("cuda", non_blocking=True)
            if has_invalid:
                invalid.to("cuda", non_blocking=True)
        r["pinned_copy_ms"] = _time_ms(copies, reps=10)
        r["pageable_uint8_copy_ms"] = _time_ms(
            lambda: torch.from_numpy(codes).to("cuda"), reps=10)
        with _profiled(f"upload {label}") as p:
            extract_stream(codes, k, "cuda")
        r["htod"] = _htod_rows(p.rows)
        ev = _by_name(p.rows)
        r["device_ms"] = sum(ms for _, ms, _ in ev)
        with _profiled(f"upload {label} uint8") as p:
            extract_canonical_kmers(torch.from_numpy(codes).to("cuda"), k)
        r["uint8_path_device_ms"] = sum(ms for _, ms, _ in _by_name(p.rows))
        del packed, invalid
        print(f"[upload {label}] {r['rows']} rows: uint8 {r['uint8_bytes']} B"
              f" -> packed {r['packed_bytes']} B + mask {r['mask_bytes']} B "
              f"(a code >= 4 in the real columns: {has_invalid})", flush=True)
        print(f"[upload {label}] host packing into pinned tensors "
              + (f"cold {r['pack_cold_s'] * 1e3:.2f} ms, "
                 if "pack_cold_s" in r else "")
              + "warm " + " / ".join(f"{x * 1e3:.2f}" for x in r["pack_warm_s"])
              + " ms; extract_stream "
              + (f"first {r['extract_first_s'] * 1e3:.2f} ms, "
                 if "extract_first_s" in r else "")
              + "warm " + " / ".join(f"{x * 1e3:.2f}"
                                     for x in r["extract_warm_s"])
              + " ms; in chunks of " + ", ".join(
                  f"2^{c.bit_length() - 1} rows " + " / ".join(
                      f"{x * 1e3:.2f}" for x in r[f"extract_chunk_{c}_s"])
                  for c in CHUNKS)
              + " ms; the uint8 path (pageable copy, no packing) "
              + " / ".join(f"{x * 1e3:.2f}" for x in r["uint8_path_s"])
              + " ms", flush=True)
        print(f"[upload {label}] CUDA events: pinned copies "
              f"{r['pinned_copy_ms']:.4f} ms, pageable uint8 copy "
              f"{r['pageable_uint8_copy_ms']:.4f} ms; profiled call: device "
              f"busy {r['device_ms']:.3f} ms (the uint8 path's "
              f"{r['uint8_path_device_ms']:.3f} ms)", flush=True)
        for name, ms, n in ev[:14]:
            print(f"[upload {label}]   {ms:8.3f} ms x{n:<4d} {name[:110]}",
                  flush=True)
        _print_htod(f"upload {label}", r["htod"])
    return res


# the count's chunk shapes (extract_stream's 2^18 rows): yeast's 150
# bases at k = 31, codes100's 100 at k = 21
EXTRACT_SHAPES = (("yeast chunk", 1 << 18, 150, 31),
                  ("codes100 chunk", 1 << 18, 100, 21))


def phase_extract() -> dict:
    """The extraction kernel (csrc/extract.cu) against its plain version
    on the card, exactly, at the count's chunk shapes (EXTRACT_SHAPES),
    with and without the mask, timed with CUDA events beside its bound
    (the keys written once, packed and mask read once, over 3.35 TB/s;
    the store alone apart) and the plain version, and one call split by
    kernel (one `extract_tiles` launch a call). The edge cases (every
    (k, L) of the CPU tests' grid, segmented rows, odd byte offsets) are
    the cuda lane's (tests/test_torch_cuda.py)."""
    import numpy as np
    import torch
    from genome_tpu_torch.kernels import extract
    rng = np.random.default_rng(26)

    def case(B, L, k, masked):
        codes = rng.integers(0, 4, (B, L), dtype=np.uint8)
        if masked:
            codes[rng.random((B, L)) < 0.002] = 4
            codes[0, 0] = 4
        packed, invalid, _ = extract.pack_codes_host(codes)
        return packed.to("cuda"), invalid.to("cuda") if masked else None

    rows = []
    for label, B, L, k in EXTRACT_SHAPES:
        for masked in (False, True):
            packed, invalid = case(B, L, k, masked)
            n = B * (L - k + 1)
            out = torch.empty(n, dtype=torch.int64, device="cuda")

            def kern():
                extract.extract_canonical_kmers_packed(packed, invalid, k, L,
                                                       out=out)

            def plain():
                return extract.extract_canonical_kmers_packed_ref(
                    packed, invalid, k, L)
            kern()
            if not torch.equal(out, plain()):
                raise AssertionError(f"extract {label}: kernel != plain")
            in_bytes = packed.numel() + (0 if invalid is None
                                         else invalid.numel())
            r = dict(label=label, rows=B, L=L, k=k, masked=masked,
                     windows=n, ms=_time_ms(kern),
                     plain_ms=_time_ms(plain, reps=3),
                     bound_ms=(8 * n + in_bytes) / HBM_BYTES_PER_S * 1e3,
                     store_bound_ms=8 * n / HBM_BYTES_PER_S * 1e3,
                     bound_by="bytes")
            rows.append(r)
            print(f"[extract {label}{' mask' if masked else ''}] {B} x {L}, "
                  f"k = {k}, {n} windows: kernel {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms (store alone "
                  f"{r['store_bound_ms']:.4f}; x{r['ms'] / r['bound_ms']:.2f}"
                  f"), plain {r['plain_ms']:.3f} ms", flush=True)
            del out
    counts = {}
    packed, invalid = case(*EXTRACT_SHAPES[0][1:], False)
    split = _device_split("extract yeast chunk", lambda: (
        extract.extract_canonical_kmers_packed(packed, None, 31, 150)),
        counts=counts)
    if [n for name, n in counts.items() if "extract_tiles" in name] != [1]:
        raise AssertionError(f"extract: launches a call {counts}")
    return {"shapes": rows, "split": split}


def _write_fastq(path, reads) -> None:
    """Reads (strings) as FASTQ records @r<i>, written 2^16 at a time."""
    step = 1 << 16
    with open(path, "w") as f:
        for i in range(0, len(reads), step):
            f.write("".join(f"@r{j}\n{r}\n+\n{'I' * len(r)}\n"
                            for j, r in enumerate(reads[i : i + step], i)))


def phase_native_ingest(w, params, golden) -> dict:
    """The CLI as a user runs it on a FASTQ: the legacy workload's real
    reads written as FASTQ, then cli.main with --io native on the card
    three times (a warm-up; a timed run with the compaction counters set
    to 0 just before and read just after; a profiled run for its
    host-to-device copies). Each run's contigs must give the legacy golden
    SHA; the profiled run must upload the codes as pinned copies of
    exactly the packed bytes: no mask and no pageable copy of 1 MiB or
    more."""
    from genome_tpu_torch.assemble import cli
    from genome_tpu_torch.io import read_fastx
    from genome_tpu_torch.io.benchdata import (codes_to_reads, contigs_sha,
                                               workload_key)
    from genome_tpu_torch.kernels import compact
    want = golden[workload_key(w, params.params_hash())]
    n, L = w["num_reads"], w["read_len"]
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "reads.fastq")
        t0 = time.perf_counter()
        _write_fastq(fq, codes_to_reads(w["err"], n))
        print(f"[native ingest] wrote {n} reads as FASTQ "
              f"({os.path.getsize(fq)} B) in {time.perf_counter() - t0:.2f} s",
              flush=True)

        def run(tag):
            out = os.path.join(td, f"{tag}.fasta")
            m = os.path.join(td, f"{tag}.jsonl")
            rc = []
            wall = _wall(lambda: rc.append(cli.main([
                fq, "-o", out, "--io", "native", "--device", "cuda",
                "--quiet", "--metrics", m, "--k", str(params.k),
                "--min-coverage", str(params.min_coverage)])))
            if rc != [0]:
                raise AssertionError(f"native ingest {tag}: the CLI gave {rc}")
            sha = contigs_sha(read_fastx(out))
            with open(m) as f:
                ev = [json.loads(x) for x in f]
            ph = {e["phase"]: e for e in ev if e["event"] == "phase_end"}
            r = dict(e2e_s=wall, sha=sha, read_input_s=ph["read_input"][
                "wall_s"], count_s=ph["count"]["wall_s"],
                kmers_per_s=ph["count"]["kmers_per_s"],
                n_windows=ph["count"]["n_windows"],
                phases={p: e["wall_s"] for p, e in ph.items()})
            print(f"[native ingest {tag}] e2e={wall:.4f} s read_input="
                  f"{r['read_input_s']} s count={r['count_s']} s kmers_per_s="
                  f"{r['kmers_per_s']} windows={r['n_windows']} " + " ".join(
                      f"{p}={x}" for p, x in r["phases"].items())
                  + f" sha={sha}", flush=True)
            if sha != want:
                raise AssertionError(f"native ingest {tag}: contig SHA {sha}"
                                     f" != golden {want}")
            if r["n_windows"] != n * (L - params.k + 1):
                raise AssertionError(f"native ingest: {r['n_windows']} "
                                     "windows, not the real reads' count")
            return r

        res = {"warm-up": run("warm-up")}
        compact.reset_launches()
        res["timed"] = run("timed")
        launches = dict(compact.LAUNCHES)
        missing = [s for s in compact.SITES if s != "tails"
                   and not s.startswith("dist_") and not launches.get(s)]
        print("[native ingest] launches="
              f"{json.dumps(launches, sort_keys=True)}", flush=True)
        if missing:
            raise AssertionError(f"native ingest: no kernel launch at "
                                 f"{missing}")
        with _profiled("native ingest") as p:
            res["profiled"] = run("profiled")
        htod = _htod_rows(p.rows)
    _print_htod("native ingest", htod)
    packed = n * -(-L // 4)
    if (sum(r["bytes"] for r in htod if r["kind"] == "Pinned") != packed
            or any(r["kind"] != "Pinned" and r["bytes"] >= 1 << 20
                   for r in htod)):
        raise AssertionError(f"native ingest: the codes did not go up as "
                             f"pinned copies of {packed} packed bytes: "
                             f"{htod}")
    res.update(launches=launches, htod=htod, packed_bytes=packed)
    return res


def _shape_row(label, site, flags, arrays, cap) -> dict:
    """compact_flagged against its plain version on one site's inputs,
    then the kernel, the plain version and the library call timed, beside
    the bound."""
    from genome_tpu_torch.kernels.compact import (compact_flagged,
                                                  compact_flagged_ref)
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
    print(f"[{label}] {site:13s} n={n:>10d} cap={cap:>9d} "
          f"kept={kept:>9d} kernel={ms:8.3f} ms plain={plain:8.3f} ms "
          f"bound={bound:7.4f} ms (32 B sectors {sector_bound:7.4f} ms) "
          f"library={lib:8.3f} ms", flush=True)
    return dict(site=site, n=n, payload_bytes=[
                    a.element_size() for a in arrays],
                capacity=cap, total=total, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by="bytes",
                sector_bound_ms=sector_bound, library_ms=lib)


def phase_kernels(shapes, gen) -> list[dict]:
    """Kernel vs plain version at edge cases and at the main path's shapes
    (`shapes`: (site, make_inputs, capacity)), each shape timed; one call
    at count_heads and at compact_ids split by kernel, and the host time
    per call at compact_ids."""
    import torch
    from genome_tpu_torch.kernels import cubuild
    from genome_tpu_torch.kernels.compact import compact_flagged

    i32, i64 = torch.int32, torch.int64
    tile = int(cubuild.load("compact").compact_tile_size())
    edge = [  # (n, p, payload dtypes, capacity, view offset)
        (0, .5, (i64,), 16, 0), (1, 1., (i32,), 1, 0),
        (1025, .5, (i64, i32), 2048, 0), (1025, 0., (i32,), 2048, 0),
        (1025, 1., (i32,), 2048, 0), (100_000, .5, (i64,), 1000, 0),
        (12_305, .3, (i32,) * 6, 50_000, 0),
        (100_000, .5, (i64, i32), 1 << 17, 1),
        (3 * tile, .5, (i32, i64), 1 << 17, 3),
        (tile + 1, 1., (i64,), 2 * tile, 8),
        (tile + 1, .5, (i64, i32), 2 * tile, 0),
        (tile - 1, .5, (i32,), tile, 0),
        (17, 1., (i64,), 32, 0), (17, .6, (i32,), 32, 3),
        (5 * tile, .5, (i64, i32), 2 * tile + 77, 0),
        (1 << 23, 1., (i64,), 1 << 23, 0)]
    for n, p, dts, cap, off in edge:
        _compare(*_rand(n, p, dts, gen, off), cap)
    print(f"[kernels] {len(edge)} edge cases equal the plain version "
          f"(n = 0, 1, 1025; none, all, overflow; 6 payloads; views at "
          f"offsets 1, 3, 8; n = tile +- 1 and 17 (tile {tile}); capacity "
          "cut mid-tile; every flag set at 2^23)", flush=True)

    rows = []
    for site, make_inputs, cap in shapes:
        flags, arrays = make_inputs()
        row = _shape_row("kernels", site, flags, arrays, cap)
        rows.append(row)
        ms, lib = row["ms"], row["library_ms"]
        if site in ("count_heads", "compact_ids"):
            row["split"] = _device_split(
                f"compact {site}", lambda: compact_flagged(flags, arrays, cap))
            row["device_ms"] = sum(row["split"].values())
        if site == "compact_ids":
            row["host_us"] = _host_us(
                lambda: compact_flagged(flags, arrays, cap))
            print(f"[kernels] compact_ids host time per call "
                  f"{row['host_us']:.2f} us (1000 calls, no sync); device "
                  f"{row['device_ms'] * 1e3:.2f} us; CUDA events "
                  f"{ms * 1e3:.2f} us; library {lib * 1e3:.2f} us",
                  flush=True)
        del flags, arrays
    return rows


def phase_profile(label, fn, wall_s: float) -> dict:
    """One more run of `fn` under torch.profiler: the device time by
    kernel, and the idle share against `wall_s`, the same run's unprofiled
    wall (the profiler's own start-up inflates the profiled wall)."""
    import torch
    with _profiled(label) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = _by_name(p.rows)
    busy_ms = sum(ms for _, ms, _ in ev)
    idle = 1 - busy_ms / (wall_s * 1e3)
    print(f"[{label}] device busy={busy_ms:.1f} ms; unprofiled wall="
          f"{wall_s * 1e3:.1f} ms idle_share={idle:.3f}"
          f" (profiled wall {wall_ms:.1f} ms)", flush=True)
    for name, ms, n in ev[:12]:
        print(f"[{label}]   {ms:8.2f} ms x{n:<5d} {name[:90]}", flush=True)
    _print_htod(label, _htod_rows(p.rows))
    return dict(device_busy_ms=busy_ms, idle_share=idle)


def phase_e2e(name, w, params, golden, counter="sort", ckpt=None) -> dict:
    import torch
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.assemble.pipeline import run_pipeline
    from genome_tpu_torch.io.benchdata import contigs_sha, workload_key
    from genome_tpu_torch.kernels import compact, extract

    key = workload_key(w, params.params_hash())
    want = golden.get(key)
    if want is None:
        raise AssertionError(f"{name}: no golden SHA cached for {key}")
    m = Metrics(quiet=True)
    torch.cuda.reset_peak_memory_stats()
    compact.reset_launches()
    extract.reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(w["err"], params, capacity=w["capacity"], metrics=m,
                       ckpt=ckpt, counter=counter, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(compact.LAUNCHES)
    ext_launches = sum(extract.LAUNCHES.values())
    sha = contigs_sha(res["contigs"])
    phases = {e["phase"]: e for e in m.events if e["event"] == "phase_end"}
    rounds = sum(e["event"] == "simplify_round" for e in m.events)
    resumed = "count" not in phases
    if resumed != (ckpt is not None):
        raise AssertionError(f"{name}: count phase resumed={resumed}")
    print(f"[e2e {name}] wall={wall:.3f} s "
          + " ".join(f"{p}={e['wall_s']:.3f}s" for p, e in phases.items())
          + f" final={phases['contigs']['final_s']:.3f}s "
          f"emit={phases['contigs']['emit_s']:.3f}s rounds={rounds}",
          flush=True)
    print(f"[e2e {name}] windows={res['stats']['n_windows']} "
          f"unique={res['stats']['n_unique']} alive={res['stats']['n_alive']}"
          f" contigs={len(res['contigs'])} "
          f"bp={sum(map(len, res['contigs']))} peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    # the count extracts the code matrix once, one kernel launch a chunk
    # of extract_stream's 2^18 rows; a resumed run does not extract
    chunks = 0 if resumed else -(-w["err"].shape[0] // (1 << 18))
    if not resumed:
        print(f"[count {counter}] {name}: wall={phases['count']['wall_s']} s "
              f"kmers_per_s={phases['count']['kmers_per_s']} retries="
              f"{sum(e['event'] == 'capacity_overflow' for e in m.events)} "
              f"extract_chunks={phases['count'].get('extract_chunks')}",
              flush=True)
        if phases["count"].get("extract_chunks") != chunks:
            raise AssertionError(f"{name}: extract_chunks "
                                 f"{phases['count'].get('extract_chunks')}"
                                 f", not {chunks}")
    print(f"[e2e {name}] launches={json.dumps(launches, sort_keys=True)} "
          f"extract={ext_launches}", flush=True)
    if ext_launches != chunks:
        raise AssertionError(f"{name}: {ext_launches} extraction launches "
                             f"for {chunks} chunks")
    print(f"[e2e {name}] sha={sha} golden={want}", flush=True)
    if sha != want:
        raise AssertionError(f"{name}: contig SHA {sha} != golden {want}")
    # the bucket and hash-table counters compact at count_weighted's
    # `count_merge` site instead of the two sort-path count sites; a
    # resumed run does not count at all
    need = [s for s in compact.SITES if s != "tails"
            and not s.startswith("dist_")
            and not (s.startswith("count") and (counter != "sort" or resumed))]
    if counter != "sort" and not resumed:
        need.append("count_merge")
    missing = [s for s in need if launches.get(s, 0) == 0]
    if missing:
        raise AssertionError(f"{name}: no kernel launch at {missing}")
    return dict(wall_s=wall, launches=launches, sha=sha,
                extract_launches=ext_launches,
                phases={p: e["wall_s"] for p, e in phases.items()})


def _bitonic_inputs(block, nblocks, dtypes, fill, gen):
    """Arrays for the bitonic kernels: keys by `fill` (random, ties,
    equal, sentinel rows), payloads random; all below 2^31 except the
    INT64_MAX rows."""
    import torch
    from genome_tpu_torch.kernels.keys import SENTINEL
    hi = {"random": 2**31 - 1, "ties": 3, "equal": 1, "sentinel": 2**31 - 1}
    out = []
    for dt in dtypes:
        a = torch.randint(0, hi[fill], (block * nblocks,), dtype=dt,
                          device="cuda", generator=gen)
        if fill == "sentinel" and dt == torch.int64:
            a[::5] = SENTINEL
        out.append(a)
    return tuple(out)


def _bitonic_compare(name, arrays, num_keys, block) -> float:
    """Kernel vs plain version on the card, exactly; returns max abs err."""
    import torch
    from genome_tpu_torch.kernels import bitonic
    got = getattr(bitonic, name)(arrays, num_keys, block)
    want = getattr(bitonic, name + "_ref")(arrays, num_keys, block)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              if a.numel() else 0 for a, b in zip(got, want))
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{name} != plain version at block {block} "
                             f"(max abs err {err})")
    return float(err)


def _network_stages(block: int, merge_only: bool) -> int:
    lg = block.bit_length() - 1
    return lg if merge_only else lg * (lg + 1) // 2


def _launch_split(label, fn, reps: int = 3) -> list[dict]:
    """Device time of each __global__ launch of one call of `fn`, in launch
    order (the mean over `reps` profiled calls after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    with _profiled(label) as p:
        for _ in range(reps):
            fn()
    ev = p.rows
    per = len(ev) // reps
    split = [dict(kernel=ev[i]["name"], ms=sum(
        ev[i + c * per]["dur"] for c in range(reps)) / reps / 1e3)
        for i in range(per)]
    print(f"[{label}] device time per __global__ launch, in order "
          f"({len(ev)} launches in {reps} calls): " + "; ".join(
              f"{s['kernel'][:48]} {s['ms']:.4f} ms" for s in split)
          + f"; total {sum(s['ms'] for s in split):.4f} ms", flush=True)
    return split


def phase_bitonic(keys, gen) -> dict:
    """sort_blocks and merge_blocks against their plain versions at edge
    cases and at the count site (`keys`: the legacy window stream, padded
    to whole blocks), each count-site shape timed and one call of each
    split by __global__ launch; then sort_pairs_merge whole against
    torch.sort. Returns {kernel name: [rows]}, the sort_pairs_merge row
    under "sort_pairs_merge" and the splits under "split"."""
    import torch
    from genome_tpu_torch.kernels import bitonic
    from genome_tpu_torch.kernels.mergesort import sort_pairs_merge
    i32, i64 = torch.int32, torch.int64
    probe = [torch.zeros(1, dtype=dt, device="cuda") for dt in (i64, i32)]
    tile = bitonic.tile_size(probe[:1], 1 << 30)
    tile2 = bitonic.tile_size(probe, 1 << 30)
    tile4 = bitonic.tile_size(probe * 2, 1 << 30)
    # one int64 key at every block size from 2^8 to 2^17: the in-thread,
    # in-warp, cross-warp and cross-tile stages of the network
    edge = [(f"block 2^{b}", 1 << b, 2, (i64,), 1, "random")
            for b in range(8, 18)]
    edge += [("block 256", 256, 8, (i64,), 1, "random"),
             ("block == TILE", tile, 3, (i64,), 1, "random"),
             ("block > TILE", 4 * tile2, 2, (i64, i32), 1, "ties"),
             ("one block", BLOCK, 1, (i64,), 1, "random"),
             ("2 keys + payloads", 1024, 4, (i32, i64, i32, i64), 2, "ties"),
             ("2 int64 keys + 2 payloads", 4 * tile4, 2, (i64, i64, i32, i64),
              2, "ties"),
             ("3 arrays", 4 * tile4, 2, (i64, i32, i64), 1, "ties"),
             ("all-equal keys", 512, 4, (i64, i32), 1, "equal"),
             ("heavy ties", 4096, 4, (i64, i32), 1, "ties"),
             ("INT64_MAX rows", BLOCK, 2, (i64, i64), 1, "sentinel")]
    for label, block, nb, dts, nk, fill in edge:
        arrays = _bitonic_inputs(block, nb, dts, fill, gen)
        for name in ("sort_blocks", "merge_blocks"):
            _bitonic_compare(name, arrays, nk, block)
    print(f"[bitonic] TILE = {tile} (int64 keys), {tile2} (int64 + int32), "
          f"{tile4} (four arrays); {len(edge)} edge cases x 2 kernels equal "
          "the plain version: " + ", ".join(e[0] for e in edge), flush=True)

    half = torch.sort(keys.view(-1, BLOCK // 2), dim=1).values.view(
        -1, 2, BLOCK // 2)
    srt = torch.sort(keys).values
    shapes = [("sort_blocks", "unsorted", keys), ("sort_blocks", "sorted", srt),
              ("merge_blocks", "bitonic", torch.cat(
                  [half[:, :1], half[:, 1:].flip(-1)], 1).reshape(-1)),
              ("merge_blocks", "sorted", srt)]
    del half
    rows: dict = {"sort_blocks": [], "merge_blocks": [], "split": {}}
    for name, label, x in shapes:
        fn = getattr(bitonic, name)
        ref = getattr(bitonic, name + "_ref")
        err = _bitonic_compare(name, (x,), 1, BLOCK)
        ms = _time_ms(lambda: fn((x,), 1, BLOCK))
        plain = _time_ms(lambda: ref((x,), 1, BLOCK), reps=2)
        lib = _time_ms(lambda: torch.sort(x.view(-1, BLOCK), dim=1), reps=5)
        n = x.numel()
        bytes_ms = 2 * n * x.element_size() / HBM_BYTES_PER_S * 1e3
        cx = n // 2 * _network_stages(BLOCK, name == "merge_blocks")
        ops_ms = cx / OPS_PER_S * 1e3
        row = dict(input=label, n=n, block=BLOCK, tile=tile,
                   compare_exchanges=cx, max_abs_err=err, ms=ms,
                   plain_ms=plain, bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                   library_ms=lib)
        rows[name].append(row)
        print(f"[bitonic] {name:12s} {label:8s} n={n} kernel={ms:8.3f} ms "
              f"plain={plain:9.3f} ms bound={row['bound_ms']:7.4f} ms "
              f"({row['bound_by']}; bytes {bytes_ms:.4f}, ops {ops_ms:.4f}) "
              f"library={lib:8.3f} ms", flush=True)
        if not rows["split"].get(name):
            rows["split"][name] = _launch_split(
                f"bitonic {name} {label}", lambda: fn((x,), 1, BLOCK))
    del srt, shapes

    got = sort_pairs_merge(keys)
    if not torch.equal(got, torch.sort(keys).values):
        raise AssertionError("sort_pairs_merge != torch.sort")
    del got
    ms = _time_ms(lambda: sort_pairs_merge(keys), reps=3)
    lib = _time_ms(lambda: torch.sort(keys), reps=10)
    bound = 2 * keys.numel() * 8 / HBM_BYTES_PER_S * 1e3
    rows["sort_pairs_merge"] = dict(n=keys.numel(), block=BLOCK, ms=ms,
                                    torch_sort_ms=lib, bound_ms=bound)
    print(f"[bitonic] sort_pairs_merge n={keys.numel()} {ms:.3f} ms vs "
          f"torch.sort {lib:.3f} ms (one-read, one-write bound "
          f"{bound:.4f} ms)", flush=True)
    return rows


def _partition_compare(bid, rem, B, cap) -> float:
    """partition_by_bucket vs its plain version on the card: totals and
    overflow exactly, and out[b, :min(totals[b], cap)]; returns max abs
    err. The synchronize surfaces any fault of an out-of-bounds write."""
    import torch
    from genome_tpu_torch.kernels.partition import (partition_by_bucket,
                                                    partition_by_bucket_ref)
    out, totals, ovf = partition_by_bucket(bid, rem, B, cap)
    rout, rtotals, rovf = partition_by_bucket_ref(bid, rem, B, cap)
    torch.cuda.synchronize()
    kept = torch.arange(cap, device=out.device) \
        < totals.clamp(max=cap).unsqueeze(1)
    err = int((totals - rtotals).abs().max())
    if kept.any():
        err = max(err, int((out[kept].to(torch.int64)
                            - rout[kept].to(torch.int64)).abs().max()))
    if err or bool(ovf) != bool(rovf):
        raise AssertionError(f"partition_by_bucket != plain version at n="
                             f"{bid.numel()} B={B} cap={cap} (max abs err "
                             f"{err}, overflow {bool(ovf)}/{bool(rovf)})")
    return float(err)


def _hist_compare(keys, nbits, shift) -> float:
    import torch
    from genome_tpu_torch.kernels.hist import (digit_histogram,
                                               digit_histogram_ref)
    got = digit_histogram(keys, nbits, shift)
    want = digit_histogram_ref(keys, nbits, shift)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or int(got.sum()) != keys.numel():
        raise AssertionError(f"digit_histogram != plain version at n="
                             f"{keys.numel()} ({nbits}, {shift}) (max abs "
                             f"err {err})")
    return float(err)


def _hist_partition_edges(gen) -> None:
    """Both kernels against their plain versions at edge cases."""
    import torch
    from genome_tpu_torch.kernels import partition
    from genome_tpu_torch.kernels.keys import SENTINEL
    from genome_tpu_torch.kernels.partition import CHUNK
    i32, i64 = torch.int32, torch.int64

    def keys(n, fill):
        k = torch.randint(0, 1 << 42, (n,), device="cuda", generator=gen)
        if fill == "equal":
            k[:] = 12345
        elif fill == "sorted":
            k = torch.sort(k).values
        elif fill == "sentinel":
            k[::7] = SENTINEL - torch.randint(0, 3000, k[::7].shape,
                                              device="cuda", generator=gen)
        elif fill == "hot":  # 90 % of the keys one key, at random places
            k[torch.rand(n, device="cuda", generator=gen) < 0.9] = \
                0x2A5A5A5A5A5
        return k

    hedge = [(0, 8, 0, "random"), (5, 8, 0, "random"),
             (100_001, 10, 32, "misaligned"), (1_000_000, 8, 0, "equal"),
             (1_000_000, 8, 56, "sentinel"), (1_000_000, 1, 63, "sentinel"),
             (1_000_000, 13, 29, "random"), (1_000_000, 16, 0, "random"),
             (1_000_000, 16, 26, "sorted"),
             # hot bins; 64 and 128 KB of counters a block; the pair
             # cluster (16 bits) at few keys, misaligned, and with a
             # partial last step and pair
             (3_000_000, 10, 32, "hot"), (3_000_000, 16, 26, "hot"),
             (3_000_000, 8, 56, "sentinel"), (1_000_000, 14, 0, "random"),
             (1_000_000, 15, 20, "random"), (1, 16, 0, "random"),
             (31, 16, 0, "random"), (33, 16, 0, "random"),
             (100_001, 16, 0, "misaligned"), (41_037, 16, 20, "random"),
             (41_037, 16, 3, "misaligned"), (41_037, 15, 3, "misaligned"),
             (1_000_000, 5, 37, "random"), (1_000_000, 2, 0, "random")]
    for n, nbits, shift, fill in hedge:
        k = keys(n + 1, "random")[1:] if fill == "misaligned" \
            else keys(n, fill)
        _hist_compare(k, nbits, shift)
    print(f"[hist] {len(hedge)} edge cases equal the plain version (n = 0, "
          "1, 5, 31, 33, odd and misaligned; all-equal, sorted and hot "
          "keys; sentinels at (8, 56) and (1, 63); nbits 2, 5, 13, 14, 15, "
          "and 16 (the pair cluster) with a partial last step and pair)",
          flush=True)

    tile = partition._lib()._tile
    pedge = [(0, 4, 1024, "random", i32, i32, 0),
             (1000, 8, 2048, "random", i32, i32, 0),
             (200_000, 5, 201_728, "one", i32, i32, 0),
             (200_000, 1, 201_728, "random", i32, i64, 0),
             (300_000, 4, 100_352, "out of range", i32, i32, 0),
             (300_000, 4, 8192, "hot0", i32, i32, 0),
             (500_000, 1025, 2048, "random", i64, i64, 0),
             (1_000_000, 1025, 4096, "sorted", i32, i32, 0),
             # many tiles (long look-back chains), buckets empty in every
             # other tile; cap None: the largest bucket plus one CHUNK
             ((300, 0), 2, None, "random", i32, i32, 0),
             ((400, 3), 1025, None, "sparse", i32, i32, 0),
             ((200, 5), 4096, None, "sparse", i32, i64, 0),
             ((150, 0), 4096, None, "random", i64, i64, 0),
             ((40, 0), 1025, None, "tail", i32, i32, 0),  # one-bucket tail
             ((7, -1), 9, None, "random", i32, i32, 0),   # a tile multiple
             ((7, 1), 9, None, "random", i64, i32, 0),    # -1 and +1
             ((5, 3), 7, None, "random", i32, i32, 1),    # bid[1:], rem[1:]
             ((5, 3), 7, None, "random", i64, i64, 1),
             ((5, 3), 1025, None, "out of range", i32, i64, 1),
             ((4, 0), 4, 8192, "hot0", i64, i64, 0)]      # cap mid-tile
    for n, B, cap, fill, bdt, rdt, off in pedge:
        n = n if isinstance(n, int) else n[0] * tile + n[1]
        lo, hi = (-3, B + 3) if fill == "out of range" else (0, B)
        bid = torch.randint(lo, hi, (n + off,), device="cuda", generator=gen,
                            dtype=bdt)
        if fill == "one":
            bid[:] = B - 1
        elif fill == "hot0":  # bucket 0 overflows into nothing: bucket 1's
            # region is compared in full
            bid[torch.rand(n + off, device="cuda", generator=gen) < 0.9] = 0
        elif fill == "sorted":
            bid = torch.sort(bid).values
        elif fill == "sparse":  # odd tiles: the lowest third of the buckets
            odd = (torch.arange(n + off, device="cuda") - off) // tile % 2
            bid[odd == 1] %= B // 3 + 1
        elif fill == "tail":  # the last eight tiles all in the last bucket
            bid[-8 * tile:] = B - 1
        rem = torch.randint(-2**31, 2**31 - 1, (n + off,), device="cuda",
                            generator=gen, dtype=rdt)
        bid, rem = bid[off:], rem[off:]
        if cap is None:
            keep = (bid >= 0) & (bid < B)
            top = int(torch.bincount(bid[keep].long(), minlength=B).max())
            cap = (top // CHUNK + 2) * CHUNK
        _partition_compare(bid, rem, B, cap)
    print(f"[partition] {len(pedge)} edge cases equal the plain version "
          "(n = 0, n < one tile, one bucket, B = 1, out-of-range bids, an "
          "overflowing bucket, int64 bids and payloads, sorted bids; "
          f"{tile}-element tiles: up to 400 of them at B = 2, 1025 and "
          "4096 with buckets empty in every other tile, a one-bucket tail, "
          "n a tile multiple -1 and +1, views at offset 1, a cap reached "
          "mid-tile)", flush=True)


def _device_split(label, fn, reps: int = 3, counts=None) -> dict:
    """Device time per kernel of `fn` under torch.profiler, per call:
    {kernel name: ms}, printed. `counts`, a dict, if given, receives each
    kernel's launches per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    with _profiled(label) as p:
        for _ in range(reps):
            fn()
    ev = _by_name(p.rows)
    split = {name: ms / reps for name, ms, _ in ev}
    if counts is not None:
        counts.update({name: n / reps for name, _, n in ev})
    print(f"[{label}] device time per call by kernel: " + "; ".join(
        f"{k[:40]} {ms:.4f} ms" for k, ms in list(split.items())[:6]),
        flush=True)
    return split


def phase_hist_partition(keys, gen) -> dict:
    """digit_histogram and partition_by_bucket on the count stream (`keys`:
    the legacy window stream, sentinels included). Their path is their own
    entry points, driven as a user would: the (10, 32) histogram of the
    keys sizes a 1025-way partition of (bucket, low word), with the
    sentinels in the last bucket. Then edge cases and each shape checked
    against the plain version and timed. Returns {kernel name: row}."""
    import torch
    from genome_tpu_torch.kernels import hist, partition
    from genome_tpu_torch.kernels.hist import (digit_histogram,
                                               digit_histogram_ref,
                                               digits_ref)
    from genome_tpu_torch.kernels.keys import INT64_MAX
    from genome_tpu_torch.kernels.partition import (CHUNK,
                                                    partition_by_bucket,
                                                    partition_by_bucket_ref)
    n = keys.numel()
    B = 1025
    n_sent = int((keys > INT64_MAX - (1 << 32)).sum())
    hist.reset_launches()
    partition.reset_launches()
    h = digit_histogram(keys, 10, 32)
    bid = torch.clamp(keys >> 32, max=B - 1).to(torch.int32)
    rem = (keys << 32 >> 32).to(torch.int32)  # the low word, bit for bit
    cap = (-(-int(h.max()) // CHUNK) + 1) * CHUNK
    out, totals, ovf = partition_by_bucket(bid, rem, B, cap)
    torch.cuda.synchronize()
    launches = {**hist.LAUNCHES, **partition.LAUNCHES}
    if launches != {"digit_histogram": 1, "partition_by_bucket": 1}:
        raise AssertionError(f"hist/partition path launches {launches}")
    if bool(ovf) or int(totals[B - 1]) != n_sent \
            or int(totals.sum()) != n:
        raise AssertionError(f"partition of the count stream: overflow "
                             f"{bool(ovf)}, sentinel bucket "
                             f"{int(totals[B - 1])} of {n_sent}")
    skew = float(h.max()) / (n / 1024)
    print(f"[hist] (10, 32) of the count stream: n={n} sentinels={n_sent} "
          f"max bin={int(h.max())} (bin {int(h.argmax())}) skew max/avg="
          f"{skew:.4f}; partition B={B} bucket_cap={cap} largest total="
          f"{int(totals.max())} launches={json.dumps(launches)}", flush=True)
    del out, totals
    _hist_partition_edges(gen)

    srt = torch.sort(keys).values
    hot = keys.clone()  # 90 % of the keys one key, at random places
    hot[torch.rand(n, device="cuda", generator=gen) < 0.9] = keys[n // 2]
    hrows = []
    for label, x, nbits, shift in [("(10, 32)", keys, 10, 32),
                                   ("(8, 0)", keys, 8, 0),
                                   ("(8, 56)", keys, 8, 56),
                                   ("(10, 32) sorted", srt, 10, 32),
                                   ("(10, 32) hot", hot, 10, 32),
                                   ("(13, 29)", keys, 13, 29),
                                   ("(16, 26)", keys, 16, 26)]:
        err = _hist_compare(x, nbits, shift)
        if nbits == 8 and shift == 56 and \
                int(digit_histogram(x, 8, 56)[255]) != n_sent:
            raise AssertionError("(8, 56): the sentinels are not in bin 255")
        ms = _time_ms(lambda: digit_histogram(x, nbits, shift))
        plain = _time_ms(lambda: digit_histogram_ref(x, nbits, shift), reps=5)
        d = digits_ref(x, nbits, shift)
        lib = _time_ms(lambda: torch.bincount(d, minlength=1 << nbits))
        del d
        bound = (8 * n + (8 << nbits)) / HBM_BYTES_PER_S * 1e3
        hrows.append(dict(input=label, n=n, nbits=nbits, shift=shift,
                          max_abs_err=err, ms=ms, plain_ms=plain,
                          bound_ms=bound, bound_by="bytes", library_ms=lib))
        print(f"[hist] {label:16s} n={n} kernel={ms:8.4f} ms plain="
              f"{plain:8.3f} ms bound={bound:7.4f} ms bincount of the "
              f"digits={lib:8.4f} ms", flush=True)
    del srt, hot
    print(f"[hist] contention: sorted/unsorted (10, 32) kernel time = "
          f"{hrows[3]['ms'] / hrows[0]['ms']:.3f}, hot/unsorted "
          f"{hrows[4]['ms'] / hrows[0]['ms']:.3f}", flush=True)
    hsplit = {}
    for nbits, shift, name in ((10, 32, "hist_block"),
                               (16, 26, "hist_pair")):
        calls: dict = {}
        hsplit[f"({nbits}, {shift})"] = _device_split(
            f"hist ({nbits}, {shift})",
            lambda: digit_histogram(keys, nbits, shift), counts=calls)
        kernels = {k: c for k, c in calls.items() if "emset" not in k}
        memsets = sum(c for k, c in calls.items() if "emset" in k)
        if (memsets != 1 or list(kernels.values()) != [1]
                or name not in next(iter(kernels))):
            raise AssertionError(f"one digit_histogram call at ({nbits}, "
                                 f"{shift}) ran {calls} (launches per "
                                 f"call), not one {name} launch and one "
                                 "memset")
    # the host's time a call, at a size where the device takes less: at
    # the count shape the launch queue fills and 1000 calls without a
    # sync would time the device
    small = keys[:1 << 14]
    host_us = _host_us(lambda: digit_histogram(small, 10, 32))
    small_ms = _time_ms(lambda: digit_histogram(small, 10, 32))
    print(f"[hist] (10, 32) host time per call at {small.numel()} keys "
          f"{host_us:.2f} us (1000 calls, no sync); CUDA events "
          f"{small_ms * 1e3:.2f} us", flush=True)

    err = _partition_compare(bid, rem, B, cap)
    ms = _time_ms(lambda: partition_by_bucket(bid, rem, B, cap), reps=10)
    plain = _time_ms(lambda: partition_by_bucket_ref(bid, rem, B, cap),
                     reps=3)

    def library():
        _, idx = torch.sort(bid, stable=True)
        return rem[idx], torch.bincount(bid, minlength=B)
    lib = _time_ms(library, reps=5)
    nbytes = n * (bid.element_size() + 2 * rem.element_size()) + 8 * B
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    prow = dict(n=n, num_buckets=B, bucket_cap=cap, max_abs_err=err, ms=ms,
                plain_ms=plain, bound_ms=bound, bound_by="bytes",
                library_ms=lib)
    print(f"[partition] n={n} B={B} cap={cap} kernel={ms:8.4f} ms plain="
          f"{plain:8.3f} ms bound={bound:7.4f} ms stable sort + gather + "
          f"bincount={lib:8.4f} ms", flush=True)
    calls: dict = {}
    prow["split"] = _device_split(
        "partition", lambda: partition_by_bucket(bid, rem, B, cap),
        counts=calls)
    kernels = {k: c for k, c in calls.items() if "emset" not in k}
    memsets = sum(c for k, c in calls.items() if "emset" in k)
    if (memsets != 1 or list(kernels.values()) != [1]
            or "partition_tiles" not in next(iter(kernels))):
        raise AssertionError(f"one partition_by_bucket call ran {calls} "
                             "(launches per call), not one partition_tiles "
                             "launch and one memset")
    del bid, rem
    torch.cuda.empty_cache()
    return {"launches": launches, "skew": skew,
            "digit_histogram": dict(hrows[0], shapes=hrows, split=hsplit,
                                    host_us=host_us),
            "partition_by_bucket": prow}


def phase_sorter(w, params, golden) -> dict:
    """The count layer's sorter hook on the card: count the legacy stream
    with sort_pairs_merge, hold the table against the default sorter's,
    then save it as the count checkpoint and resume run_pipeline from it
    (the contigs must equal the golden SHA)."""
    import torch
    from genome_tpu_torch.assemble.checkpoint import PhaseCheckpointer
    from genome_tpu_torch.assemble.pipeline import extract_stream
    from genome_tpu_torch.kernels import bitonic, compact
    from genome_tpu_torch.kernels.count import count_kmers_device
    from genome_tpu_torch.kernels.keys import SENTINEL
    from genome_tpu_torch.kernels.mergesort import sort_pairs_merge
    cap = w["capacity"]

    def count(sorter):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keys = extract_stream(w["err"], params.k, "cuda")
        n_windows = keys.numel()
        if n_windows % BLOCK:
            keys = torch.cat([keys, keys.new_full((-n_windows % BLOCK,),
                                                  SENTINEL)])
        res = count_kmers_device(keys, params.min_coverage, cap,
                                 sorter=sorter)
        torch.cuda.synchronize()
        return res, n_windows, time.perf_counter() - t0

    count(sort_pairs_merge)  # warm-up
    bitonic.reset_launches()
    compact.reset_launches()
    got, n_windows, wall = count(sort_pairs_merge)
    launches = dict(bitonic.LAUNCHES)
    want, _, wall_default = count(None)
    for key in ("table", "counts", "n_unique", "overflow"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"merge sorter: {key} != default sorter's")
    if bool(got["overflow"]):
        raise AssertionError("merge sorter: table overflowed its capacity")
    levels = (-(-n_windows // BLOCK) - 1).bit_length()
    print(f"[count merge-sorter] legacy: wall={wall:.4f} s kmers_per_s="
          f"{round(n_windows / wall)} (default sorter in the same call: "
          f"{wall_default:.4f} s, {round(n_windows / wall_default)}); "
          f"unique={int(got['n_unique'])} launches={json.dumps(launches)} "
          f"merge levels={levels}", flush=True)
    if launches != {"sort_blocks": 1, "merge_blocks": levels}:
        raise AssertionError(f"sorter path launches {launches}, expected "
                             f"sort_blocks 1, merge_blocks {levels}")
    with tempfile.TemporaryDirectory() as ck:
        PhaseCheckpointer(ck, params).save(
            "count", table=got["table"], counts=got["counts"],
            n_unique=int(got["n_unique"]), n_windows=n_windows)
        del got, want
        e2e = phase_e2e("legacy, resumed from the merge-sorter count", w,
                        params, golden, ckpt=PhaseCheckpointer(ck, params))
    return dict(launches=launches, count_wall_s=wall,
                default_count_wall_s=wall_default, sha=e2e["sha"])


# compact_flagged sites of the dist path: the replicated simplify's, and
# the default sharded path's (whose four own sites are timed: the passes'
# and the emission's)
DIST_SITES = ("count_heads", "count_filter", "tips", "bubbles", "kills",
              "contig_starts")
DIST_SHARDED_TIMED = ("dist_kills", "dist_bubble_cands", "dist_emit_blocks",
                      "dist_emit_heads")
DIST_SHARDED_SITES = ("count_heads", "count_filter") + DIST_SHARDED_TIMED
# the default path's phases (JAX's, genome_tpu/dist/assemble.py:55-170),
# and the fallbacks it must not take
DIST_SHARDED_PHASES = ("dist_extract", "dist_count", "dist_build",
                       "dist_simplify_sharded", "dist_final_sharded",
                       "dist_contigs")
DIST_FALLBACKS = ("dist_simplify_overflow_fallback",
                  "dist_final_fast_fallback", "dist_final_overflow_fallback",
                  "dist_emit_overflow_fallback")


@contextlib.contextmanager
def _capture_compact(when=None):
    """While open, every call of compact_flagged from the port keeps a
    copy of its inputs (flags, payloads, capacity) at the first call of
    each site (for which `when(flags, capacity)` holds, if given): yields
    {site: inputs}. Every module of the port that holds the wrapper by
    name gets a recording one, then the wrapper back."""
    from genome_tpu_torch.kernels import compact
    orig = compact.compact_flagged
    got = {}

    def recording(flags, arrays, capacity, site="direct"):
        if site not in got and (when is None or when(flags, capacity)):
            got[site] = (flags.clone(), tuple(a.clone() for a in arrays),
                         capacity)
        return orig(flags, arrays, capacity, site=site)
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("genome_tpu_torch")
            and getattr(m, "compact_flagged", None) is orig]
    for m in mods:
        m.compact_flagged = recording
    try:
        yield got
    finally:
        for m in mods:
            m.compact_flagged = orig


def _dist_e2e(name, w, params, golden, sharded: bool) -> dict:
    """assemble_sharded on a one-rank NCCL group, with the sharded or the
    replicated simplify: a warm-up that keeps compact_flagged's inputs at
    each site, each held against the plain version and timed (the dist
    path's own shapes: the count at the routed bucket length and capacity
    2^27, the replicated simplify on the gathered graph; for the sharded
    path its kill and candidate compactions on a rank's 2^23 canonical
    and 2^24 oriented ids, and the emission's block and head compactions
    on the routed records), then a timed run with the launch counters
    set to 0 just before it; the golden SHA, per-phase walls, peak device
    bytes, the exchange ledger; for the sharded path JAX's phase list and
    no fallback event, the passes run and the slack rung reached (from
    the ledger), the fast final's rounds, and the dist_final_fast and
    dist_emit ledger entries."""
    import torch
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.dist import assemble_sharded
    from genome_tpu_torch.io.benchdata import contigs_sha, workload_key
    from genome_tpu_torch.kernels import compact

    label = f"dist sharded {name}" if sharded else f"dist {name}"
    sites = DIST_SHARDED_SITES if sharded else DIST_SITES
    want = golden.get(workload_key(w, params.params_hash()))
    if want is None:
        raise AssertionError(f"{label}: no golden SHA cached")
    with _capture_compact() as inputs:  # warm-up
        assemble_sharded(w["err"], params, sharded_simplify=sharded,
                         device="cuda")
    missing = [s for s in sites if s not in inputs]
    if missing:
        raise AssertionError(f"{label}: no compact_flagged call at "
                             f"{missing}")
    timed = DIST_SHARDED_TIMED if sharded else [
        s for s in compact.SITES if s in inputs]
    shapes = [_shape_row(f"{label} kernels", site, *inputs.pop(site))
              for site in timed]
    del inputs
    m = Metrics(quiet=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    compact.reset_launches()
    t0 = time.perf_counter()
    contigs = assemble_sharded(w["err"], params, metrics=m,
                               sharded_simplify=sharded, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(compact.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sha = contigs_sha(contigs)
    ends = {e["phase"]: e for e in m.events if e["event"] == "phase_end"}
    ledger = next(e for e in m.events if e["event"] == "exchange_ledger")
    ledger = {k: v for k, v in ledger.items() if k not in ("ts", "event")}
    print(f"[{label}] P=1 NCCL wall={wall:.4f} s "
          + " ".join(f"{p}={e['wall_s']:.4f}s" for p, e in ends.items())
          + f" peak_mem_bytes={peak} contigs={len(contigs)}", flush=True)
    skip = ("ts", "event", "phase", "wall_s")
    info = {p: {k: v for k, v in e.items() if k not in skip}
            for p, e in ends.items()}
    print(f"[{label}] phase info {json.dumps(info)}", flush=True)
    print(f"[{label}] ledger={json.dumps(ledger)}", flush=True)
    print(f"[{label}] launches={json.dumps(launches, sort_keys=True)}",
          flush=True)
    print(f"[{label}] sha={sha} golden={want}", flush=True)
    if sha != want:
        raise AssertionError(f"{label}: contig SHA {sha} != golden {want}")
    missing = [s for s in sites if launches.get(s, 0) == 0]
    if missing:
        raise AssertionError(f"{label}: no kernel launch at {missing}")
    res = dict(wall_s=wall, peak_mem_bytes=peak, launches=launches, sha=sha,
               phases={p: e["wall_s"] for p, e in ends.items()},
               ledger=ledger, compact_shapes=shapes)
    if sharded:
        fell = [e["event"] for e in m.events if e["event"] in DIST_FALLBACKS]
        if tuple(ends) != DIST_SHARDED_PHASES or fell:
            raise AssertionError(f"{label}: phases {tuple(ends)} (want "
                                 f"{DIST_SHARDED_PHASES}), fallbacks {fell}")
        passes = {p: ledger[p]["invocations"]
                  for p in ("dist_degrees", "dist_tips", "dist_bubbles")}
        rung = 1 + ledger["dist_degrees"].get("retry_epochs", 0)
        rounds = next(e for e in m.events
                      if e["event"] == "dist_final_fast_rounds")
        print(f"[{label}] dist_simplify_sharded="
              f"{ends['dist_simplify_sharded']['wall_s']:.4f} s (the passes) "
              f"dist_final_sharded={ends['dist_final_sharded']['wall_s']:.4f}"
              f" s dist_contigs={ends['dist_contigs']['wall_s']:.4f} s; "
              f"passes at the last rung {json.dumps(passes)}; slack rung "
              f"{rung} (slack {1.35 * 2 ** (rung - 1):.2f}); "
              f"dist_final_fast_rounds p1={rounds['p1']} p2={rounds['p2']}; "
              f"no fallback; peak_mem_bytes={peak}", flush=True)
        for name in ("dist_final_fast", "dist_emit"):
            print(f"[{label}] ledger {name}={json.dumps(ledger[name])}",
                  flush=True)
        res.update(passes=passes, slack_rung=rung,
                   final_rounds=dict(p1=rounds["p1"], p2=rounds["p2"]))
    return res


def _dist_circular(smi: str) -> dict:
    """The final state's ladder on the card: a 200,000 bp circular random
    genome, 100 bp error-free reads at 30x, k = 21, min_coverage 1,
    through assemble_sharded on the one-rank NCCL group. The fast final
    must report the surviving cycle (dist_final_fast_fallback), the exact
    final run, and the one contig equal assemble_device's on the card."""
    import torch
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.assemble.pipeline import assemble_device
    from genome_tpu_torch.dist import assemble_sharded
    from genome_tpu_torch.io.simulate import random_genome, simulate_reads
    from genome_tpu_torch.params import AssemblyParams

    label = "dist sharded circular"
    reads = simulate_reads(random_genome(200_000, seed=91), read_len=100,
                           coverage=30, error_rate=0.0, circular=True,
                           seed=92)
    params = AssemblyParams(k=21, min_coverage=1)
    want = assemble_device(reads, params, device="cuda")
    m = Metrics(quiet=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    contigs = assemble_sharded(reads, params, metrics=m, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ends = {e["phase"]: e for e in m.events if e["event"] == "phase_end"}
    events = [e["event"] for e in m.events
              if e["event"] not in ("phase_start", "phase_end")]
    ledger = next(e for e in m.events if e["event"] == "exchange_ledger")
    exact = ledger.get("dist_final_exact", {}).get("invocations", 0)
    print(f"[{label}] {len(reads)} reads P=1 NCCL wall={wall:.4f} s "
          + " ".join(f"{p}={e['wall_s']:.4f}s" for p, e in ends.items())
          + f"; events {events}; dist_final_exact invocations {exact}; "
          f"contigs={len(contigs)} (single device {len(want)}, "
          f"{len(want[0]) if want else 0} bp) | {smi}", flush=True)
    for name in ("dist_final_fast", "dist_final_exact", "dist_emit"):
        if name in ledger:
            print(f"[{label}] ledger {name}={json.dumps(ledger[name])}",
                  flush=True)
    if "dist_final_fast_fallback" not in events or exact < 1 \
            or len(contigs) != 1 or contigs != want:
        raise AssertionError(f"{label}: the ladder did not take the exact "
                             "final, or the contig differs from "
                             "assemble_device's")
    return dict(wall_s=wall, phases={p: e["wall_s"] for p, e in ends.items()},
                events=events, exact_invocations=exact,
                contig_bp=len(contigs[0]))


# the sharded path's stages that phase_profile_sharded annotates: the
# name each has in dist/assemble.py, and its phase
SHARDED_SPANS = (("simplify_sharded", "dist_simplify_sharded"),
                 ("final_state_sharded", "dist_final_sharded"),
                 ("emit_contigs_sharded", "dist_contigs"))


def phase_profile_sharded(label, fn, phase_walls: dict) -> dict:
    """One more run of `fn` (a default assemble_sharded) under
    torch.profiler, its simplify_sharded, final_state_sharded and
    emit_contigs_sharded calls each inside a record_function: for each,
    the device time by kernel of the device records of that call's host
    calls, and the idle share against `phase_walls` (the same phases'
    unprofiled walls)."""
    import torch
    from torch.profiler import record_function
    from genome_tpu_torch.dist import assemble as dist_assemble
    origs = {name: getattr(dist_assemble, name) for name, _ in SHARDED_SPANS}

    def annotated(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            with record_function(name):
                out = origs[name](*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return call
    for name in origs:
        setattr(dist_assemble, name, annotated(name))
    try:
        with _profiled(label) as p:
            fn()
    finally:
        for name, orig in origs.items():
            setattr(dist_assemble, name, orig)
    res = {}
    for name, phase in SHARDED_SPANS:
        span = next(e for e in p.events if e.get("name") == name
                    and e.get("cat") == "user_annotation")
        ev = _by_name(_block_rows(f"{label} {phase}", p.events, name))
        busy_ms = sum(ms for _, ms, _ in ev)
        idle = 1 - busy_ms / (phase_walls[phase] * 1e3)
        print(f"[{label}] {phase} ({name}): device busy={busy_ms:.1f} ms; "
              f"unprofiled phase wall={phase_walls[phase] * 1e3:.1f} ms "
              f"idle_share={idle:.3f} (profiled span "
              f"{span['dur'] / 1e3:.1f} ms)", flush=True)
        for kname, ms, n in ev[:8]:
            print(f"[{label}]   {ms:8.2f} ms x{n:<5d} {kname[:90]}",
                  flush=True)
        res[phase] = dict(device_busy_ms=busy_ms, idle_share=idle,
                          top=[dict(name=n[:90], ms=ms, records=c)
                               for n, ms, c in ev[:8]])
    return res


def phase_dist(legacy, repeats, params, golden, smi: str) -> dict:
    """The hash-sharded path on a NCCL group of one rank on cuda:0: the
    sharded count of the legacy stream equal to count_kmers_device's table
    (compact_flagged launched at count_heads and count_filter), the count
    exchange's all_to_all_single timed (at P = 1 a local copy), then
    assemble_sharded on legacy and repeats with their golden SHAs, with
    the replicated and with the sharded simplify."""
    import torch
    import torch.distributed as dist
    from genome_tpu_torch.assemble.pipeline import extract_stream
    from genome_tpu_torch.dist import assemble_sharded
    from genome_tpu_torch.dist.count import sharded_count
    from genome_tpu_torch.dist.mesh import all_to_all_rows, init_group
    from genome_tpu_torch.kernels import compact
    from genome_tpu_torch.kernels.count import count_kmers_device

    with tempfile.TemporaryDirectory() as tmp:
        dev = init_group(0, 1, f"file://{tmp}/rendezvous", device="cuda")
        try:
            stream = extract_stream(legacy["err"], params.k, dev)
            cap = legacy["capacity"]
            bucket_cap = max(64, int(1.3 * stream.numel()) + 64)
            want = count_kmers_device(stream, params.min_coverage, cap)
            compact.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sharded_count(stream, params.min_coverage, bucket_cap, cap)
            torch.cuda.synchronize()
            count_s = time.perf_counter() - t0
            launches = dict(compact.LAUNCHES)
            for key in ("table", "counts", "n_unique"):
                if not torch.equal(got[key], want[key]):
                    raise AssertionError(
                        f"dist: sharded count {key} != count_kmers_device's")
            if got["overflow"] or bool(want["overflow"]):
                raise AssertionError("dist: count overflowed its capacity")
            print(f"[dist count] legacy P=1: sharded_count table == "
                  f"count_kmers_device table (n_unique="
                  f"{int(got['n_unique'])}, capacity {cap}, bucket_cap "
                  f"{bucket_cap}); wall {count_s:.4f} s; launches="
                  f"{json.dumps(launches, sort_keys=True)}", flush=True)
            for site in ("count_heads", "count_filter"):
                if launches.get(site, 0) == 0:
                    raise AssertionError(f"dist count: no launch at {site}")
            del got, want, stream
            buf = torch.full((1, bucket_cap), 7, dtype=torch.int64,
                             device=dev)
            a2a_ms = _time_ms(lambda: all_to_all_rows(buf))
            a2a_bytes = buf.numel() * buf.element_size()
            del buf
            print(f"[dist a2a] count exchange all_to_all_single [1, "
                  f"{bucket_cap}] int64, {a2a_bytes} bytes: {a2a_ms:.4f} ms "
                  f"(CUDA events, {REPEATS} calls; at P = 1 NCCL copies the "
                  f"buffer on the card, nothing crosses a link) | {smi}",
                  flush=True)
            e2e = {"legacy": _dist_e2e("legacy", legacy, params, golden,
                                       sharded=False),
                   "repeats": _dist_e2e("repeats", repeats, params, golden,
                                        sharded=False)}
            e2e["legacy"]["profile"] = phase_profile(
                "dist profile legacy", lambda: assemble_sharded(
                    legacy["err"], params, sharded_simplify=False,
                    device="cuda"),
                e2e["legacy"]["wall_s"])
            for name, w in (("legacy", legacy), ("repeats", repeats)):
                sh = e2e[f"sharded {name}"] = _dist_e2e(
                    name, w, params, golden, sharded=True)
                ph, rep = sh["phases"], e2e[name]["phases"]
                print(f"[dist sharded {name}] dist_simplify_sharded "
                      f"{ph['dist_simplify_sharded']:.4f} + "
                      f"dist_final_sharded {ph['dist_final_sharded']:.4f} + "
                      f"dist_contigs {ph['dist_contigs']:.4f} s beside the "
                      f"replicated branch's dist_simplify "
                      f"{rep['dist_simplify']:.4f} + dist_contigs "
                      f"{rep['dist_contigs']:.4f} s (this call); e2e "
                      f"{sh['wall_s']:.4f} s beside {e2e[name]['wall_s']:.4f}"
                      f" s | {smi}", flush=True)
            e2e["sharded legacy"]["profile"] = phase_profile_sharded(
                "dist sharded profile legacy", lambda: assemble_sharded(
                    legacy["err"], params, device="cuda"),
                e2e["sharded legacy"]["phases"])
            circular = _dist_circular(smi)
        finally:
            dist.destroy_process_group()
    return dict(count_launches=launches, count_wall_s=count_s,
                a2a_ms=a2a_ms, a2a_bytes=a2a_bytes, e2e=e2e,
                circular=circular)


# assemble_multihost's phase_times keys (JAX's, genome_tpu/dist/
# multihost.py:135-290); "write" with out_path
MULTIHOST_KEYS = ("build", "count", "emit", "exchange_ledger", "extract",
                  "final", "simplify")
BENCH_KEYS = ("metric", "process_id", "num_processes", "local_reads",
              "wall_s", "ingest_s", "reads_per_sec_local",
              "reads_per_sec_total", "phases_s", "n_contigs",
              "exchange_ledger")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(fq, out, extra=(), env_extra=None) -> subprocess.CompletedProcess:
    """python -m genome_tpu_torch.dist.launch as a user runs it: one
    process, rank 0 of 1, on cuda:0, a tcp rendezvous on 127.0.0.1 (a
    free port), k = 21, min_coverage 2, --forbid-replicated. Killed if
    it outlives 300 s."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [here] + [x for x in env.get("PYTHONPATH", "").split(os.pathsep) if x])
    return subprocess.run(
        [sys.executable, "-m", "genome_tpu_torch.dist.launch", fq, "-o", out,
         "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes",
         "1", "--process-id", "0", "--k", "21", "--min-coverage", "2",
         "--forbid-replicated", *extra],
        cwd=here, env=env, capture_output=True, text=True, timeout=300)


def _launched(label, p, rc=0) -> None:
    if p.returncode != rc:
        raise AssertionError(f"{label}: the launcher gave rc {p.returncode}"
                             f" (want {rc}): {p.stderr[-3000:]}")


def _multihost_resume(smi: str) -> dict:
    """Crash and resume through the launcher: a 500,000 bp linear genome,
    100 bp reads with 0.5 % errors at 30x, k = 21. The first launch
    exits after saving its build shard (GENOME_TPU_CRASH_AFTER=
    dist_build:0, rc 7); the second, with --resume, loads the count and
    the build (their files keep their mtimes), saves the simplify shard,
    and writes run_pipeline's contigs."""
    from genome_tpu_torch.assemble.pipeline import run_pipeline
    from genome_tpu_torch.io import read_fastx
    from genome_tpu_torch.io.simulate import random_genome, simulate_reads
    from genome_tpu_torch.params import AssemblyParams

    label = "dist multihost resume"
    reads = simulate_reads(random_genome(500_000, seed=93), read_len=100,
                           coverage=30, error_rate=0.005, seed=94)
    with tempfile.TemporaryDirectory() as td:
        fq, out = os.path.join(td, "reads.fastq"), os.path.join(td, "c.fasta")
        ck = os.path.join(td, "ckpt")
        _write_fastq(fq, reads)
        t0 = time.perf_counter()
        p = _launch(fq, out, ("--checkpoint-dir", ck),
                    {"GENOME_TPU_CRASH_AFTER": "dist_build:0"})
        crash_s = time.perf_counter() - t0
        _launched(label, p, rc=7)
        if "injected crash after dist_build" not in p.stderr:
            raise AssertionError(f"{label}: no injected crash on stderr")
        saved = {f: os.stat(os.path.join(ck, f)).st_mtime_ns
                 for f in ("dist_count.shard0.npz", "dist_build.shard0.npz")}
        sizes = {f: os.path.getsize(os.path.join(ck, f)) for f in saved}
        t0 = time.perf_counter()
        p = _launch(fq, out, ("--checkpoint-dir", ck, "--resume"))
        resume_s = time.perf_counter() - t0
        _launched(label, p)
        got = read_fastx(out)
        kept = {f: os.stat(os.path.join(ck, f)).st_mtime_ns for f in saved}
        simplified = os.path.exists(os.path.join(ck,
                                                 "dist_simplify.shard0.npz"))
    want = run_pipeline(reads, AssemblyParams(k=21, min_coverage=2),
                        device="cuda")["contigs"]
    print(f"[{label}] {len(reads)} reads: crash launch rc 7 in "
          f"{crash_s:.2f} s (shards {json.dumps(sizes)} bytes), resume "
          f"launch rc 0 in {resume_s:.2f} s; count/build shards untouched "
          f"{kept == saved}; dist_simplify.shard0.npz saved {simplified}; "
          f"{len(got)} contigs == run_pipeline's {got == want} | {smi}",
          flush=True)
    if kept != saved or not simplified or got != want:
        raise AssertionError(f"{label}: the resume did not reuse the count "
                             "and build shards, or its contigs differ from "
                             "run_pipeline's")
    return dict(reads=len(reads), crash_s=crash_s, resume_s=resume_s,
                shard_bytes=sizes, contigs=len(got))


def phase_multihost(w, params, golden, smi: str, sharded_wall: float,
                    cli_read_s: float) -> dict:
    """The multi-process entry (dist/multihost.py, dist/launch.py) at
    P = 1 on cuda:0. In process, on a NCCL group of one rank joined by
    initialize: assemble_multihost on the legacy code matrix, a warm-up
    that keeps compact_flagged's inputs at its six sites (each held
    against the plain version and timed), a timed run with the launch
    counters set to 0 just before it (golden SHA, JAX's phase_times
    keys, a launch at every site, peak bytes), then a run with out_path
    (the FASTA's SHA, no shard left). Then the launcher on the legacy
    reads as FASTQ with --bench (golden SHA, the bench record), and the
    crash and resume through the launcher (_multihost_resume)."""
    import glob

    import torch
    import torch.distributed as dist
    from genome_tpu_torch.dist.multihost import assemble_multihost, initialize
    from genome_tpu_torch.io import read_fastx
    from genome_tpu_torch.io.benchdata import (codes_to_reads, contigs_sha,
                                               workload_key)
    from genome_tpu_torch.kernels import compact

    label = "dist multihost"
    want = golden[workload_key(w, params.params_hash())]
    res = {}
    with tempfile.TemporaryDirectory() as td:
        initialize(f"file://{td}/rendezvous", 1, 0, device="cuda")
        try:
            with _capture_compact() as inputs:  # warm-up
                assemble_multihost(w["err"], params, forbid_replicated=True)
            missing = [s for s in DIST_SHARDED_SITES if s not in inputs]
            if missing:
                raise AssertionError(f"{label}: no compact_flagged call at "
                                     f"{missing}")
            shapes = [_shape_row(f"{label} kernels", site, *inputs.pop(site))
                      for site in DIST_SHARDED_SITES]
            del inputs
            pt = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            compact.reset_launches()
            t0 = time.perf_counter()
            contigs = assemble_multihost(w["err"], params,
                                         forbid_replicated=True,
                                         phase_times=pt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(compact.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            sha = contigs_sha(contigs)
            keys = tuple(sorted(pt))
            ledger = pt.pop("exchange_ledger")
            print(f"[{label}] P=1 NCCL assemble_multihost wall={wall:.4f} s "
                  + " ".join(f"{k}={v:.4f}s" for k, v in pt.items())
                  + f" (dist sharded legacy e2e {sharded_wall:.4f} s in this"
                  f" call) peak_mem_bytes={peak} contigs={len(contigs)} "
                  f"final_fast_rounds={ledger['final_fast_rounds']} | {smi}",
                  flush=True)
            print(f"[{label}] ledger={json.dumps(ledger)}", flush=True)
            print(f"[{label}] launches="
                  f"{json.dumps(launches, sort_keys=True)}", flush=True)
            print(f"[{label}] sha={sha} golden={want}", flush=True)
            if sha != want:
                raise AssertionError(f"{label}: contig SHA {sha} != golden")
            if keys != MULTIHOST_KEYS:
                raise AssertionError(f"{label}: phase_times keys {keys}")
            missing = [s for s in DIST_SHARDED_SITES if not launches.get(s)]
            if missing:
                raise AssertionError(f"{label}: no kernel launch at "
                                     f"{missing}")
            out = os.path.join(td, "contigs.fasta")
            pt_w = {}
            t0 = time.perf_counter()
            n = assemble_multihost(w["err"], params, forbid_replicated=True,
                                   phase_times=pt_w, out_path=out)
            wall_w = time.perf_counter() - t0
            sha_w = contigs_sha(read_fastx(out))
            left = glob.glob(out + ".shard*")
            print(f"[{label}] out_path: wall={wall_w:.4f} s write="
                  f"{pt_w['write']:.4f} s, {n} contigs, sha={sha_w}, shard "
                  f"files left {left}", flush=True)
            if sha_w != want or n != len(contigs) or left:
                raise AssertionError(f"{label}: out_path gave {n} contigs, "
                                     f"SHA {sha_w}, shards left {left}")
        finally:
            dist.destroy_process_group()
        del contigs
        torch.cuda.empty_cache()
        res.update(wall_s=wall, phases=pt, peak_mem_bytes=peak,
                   launches=launches, ledger=ledger, sha=sha,
                   out_path_wall_s=wall_w, compact_shapes=shapes)

        # the launcher, as a user runs it
        fq, out = os.path.join(td, "reads.fastq"), os.path.join(td, "l.fasta")
        _write_fastq(fq, codes_to_reads(w["err"], w["num_reads"]))
        bench = os.path.join(td, "bench.jsonl")
        t0 = time.perf_counter()
        p = _launch(fq, out, ("--bench", "--bench-out", bench))
        launch_s = time.perf_counter() - t0
        _launched(f"{label} launch", p)
        sha_l = contigs_sha(read_fastx(out))
        with open(bench) as f:
            rec = json.loads(f.read())
        print(f"[{label} launch] P=1 rc 0 in {launch_s:.2f} s (process, "
              f"two assemblies, write); bench wall_s={rec['wall_s']} "
              f"ingest_s={rec['ingest_s']} (the CLI's read_input "
              f"{cli_read_s} s in this call) reads_per_sec_total="
              f"{rec['reads_per_sec_total']} phases_s="
              f"{json.dumps(rec['phases_s'])} n_contigs={rec['n_contigs']} "
              f"sha={sha_l} | {smi}", flush=True)
        print(f"[{label} launch] ledger="
              f"{json.dumps(rec['exchange_ledger'])}", flush=True)
        print(f"[{label} launch] stderr: {p.stderr.strip()[-300:]}",
              flush=True)
        if sha_l != want or tuple(rec) != BENCH_KEYS:
            raise AssertionError(f"{label} launch: SHA {sha_l}, bench keys "
                                 f"{tuple(rec)}")
        res["launch"] = dict(rec, process_s=launch_s)
    res["resume"] = _multihost_resume(smi)
    return res


def _plain_rank(prev_u, take: bool = False):
    """(head, dist, ok) by plain pointer doubling over the prev links:
    log2(n2) + 1 rounds of two full-size gathers, the final state's
    ranking before the ruler ranking (x[i] gathers, which cast an int32
    index to int64 first); kept here as the smoke's own reference for
    graph/simplify.py::_rank_rulers. take: gather with index_select, as
    _rank_rulers does, for a baseline of the same gathers."""
    import torch
    g = (lambda x, i: x.index_select(0, i)) if take else \
        (lambda x, i: x[i])
    n2 = prev_u.shape[0]
    p = torch.where(prev_u >= 0, prev_u,
                    torch.arange(n2, dtype=prev_u.dtype, device=prev_u.device))
    d = (prev_u >= 0).to(torch.int32)
    for _ in range(max(1, (n2 - 1).bit_length() + 1)):
        d = d + g(d, p)
        p = g(p, p)
    return p, d, ~(g(prev_u, p) >= 0).any()


def phase_final_rank(w, params, smi: str) -> dict:
    """The final state's ranking on legacy's final links (the fixpoint
    loop's last pass, on all 2 * cap2 oriented ids): the ruler ranking
    (_rank_rulers) equal to the plain doubling (_plain_rank), and the
    three timed in turns after three untimed calls each (plain, plain
    with index_select, ruler, then in reverse, five times), each call
    between two device syncs."""
    import torch
    from genome_tpu_torch.assemble.pipeline import count_reads
    from genome_tpu_torch.graph import simplify as simp
    from genome_tpu_torch.graph.build import build_graph_device

    res = count_reads(w["err"], params, w["capacity"], device="cuda")
    n_unique = res["n_unique_host"]
    step = max(256, 1 << max(0, n_unique.bit_length() - 6))
    cap2 = -(-n_unique // step) * step
    table, counts = res["table"][:cap2], res["counts"][:cap2]
    del res
    valid = torch.arange(cap2, device="cuda") < n_unique
    succ, okv = build_graph_device(table, n_unique, params.k)
    alive, links = simp.simplify_device(
        succ, okv, counts, torch.ones(cap2, dtype=torch.bool, device="cuda"),
        valid, params, with_links=True)
    prev_u = links[1]
    del succ, okv, table, counts, alive, links
    head, dist, ok, (r1, r2) = simp._rank_rulers(prev_u)
    fns = {"plain": _plain_rank,
           "plain_take": functools.partial(_plain_rank, take=True),
           "ruler": lambda pu: simp._rank_rulers(pu)[:3]}
    for name in ("plain", "plain_take"):
        ph, pd, pok = fns[name](prev_u)
        if not (torch.equal(head, ph) and torch.equal(dist, pd)
                and bool(ok) == bool(pok) and bool(ok)):
            raise AssertionError(f"final rank: _rank_rulers != {name}")
    for fn in fns.values():  # warm-up: the ruler's walls fall over the
        for _ in range(3):   # first few calls
            fn(prev_u)[2].item()
    times = {k: [] for k in fns}
    for _ in range(5):
        for name in (*fns, *reversed(fns)):
            times[name].append(_wall(lambda: fns[name](prev_u)[2].item()))
    ms = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in times.items()}
    n2 = prev_u.numel()
    print(f"[final rank legacy] n2={n2}: _rank_rulers == plain doubling "
          f"(head, dist, ok); ruler rounds p1={r1} p2={r2} (stride "
          f"{simp.RULER_STRIDE}; plain {max(1, (n2 - 1).bit_length() + 1)} "
          f"rounds of two gathers); median of 10 walls: ruler "
          f"{ms['ruler']:.3f} ms, plain {ms['plain']:.3f} ms, plain with "
          f"index_select {ms['plain_take']:.3f} ms (each call ends in its "
          f"host read of ok) | {smi}", flush=True)
    return dict(n2=n2, p1_rounds=r1, p2_rounds=r2, ruler_ms=ms["ruler"],
                plain_ms=ms["plain"], plain_take_ms=ms["plain_take"],
                walls_ms={k: [t * 1e3 for t in v] for k, v in times.items()})


@contextlib.contextmanager
def _patched(*changes):
    """Module attributes set for the block, (module, name, value) each,
    and restored after it."""
    saved = []
    try:
        for mod, name, value in changes:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, value)
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def _spy(mod, name, calls: list, keep):
    """(mod, name, wrapper) for _patched: the wrapper calls the function
    and appends keep(args, kwargs, result) to `calls`."""
    orig = getattr(mod, name)

    def wrapper(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(keep(args, kwargs, out))
        return out
    return mod, name, wrapper


# compact_flagged sites of a single-device run (tails: only when no cycle
# survives; tips, bubbles and kills: only on a walk pass), and of the
# sharded path
BRANCH_SITES = ("count_heads", "count_filter", "build", "tips", "bubbles",
                "kills", "tails", "contig_starts")
BRANCH_DIST_SITES = ("count_heads", "count_filter", "dist_kills",
                     "dist_bubble_cands", "dist_emit_blocks",
                     "dist_emit_heads")


def _branch(name, fn, want, sites, rows) -> dict:
    """One case of the branch phase: fn() -> (contigs, taken) with the
    launch counters set to 0 just before it and read just after; fails
    unless `taken` names the event that proves the branch ran, the contigs
    equal the port's golden oracle's `want`, and every site in `sites`
    launched the kernel."""
    import torch
    from genome_tpu_torch.kernels import compact
    torch.cuda.synchronize()
    compact.reset_launches()
    t0 = time.perf_counter()
    contigs, taken = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(compact.LAUNCHES)
    equal = contigs == want
    print(f"[branch {name}] taken={taken or 'NOT TAKEN'} n_contigs="
          f"{len(contigs)} oracle={'equal' if equal else 'DIFFERENT'} "
          f"wall_s={wall:.4f}", flush=True)
    print(f"[branch {name}] launches={json.dumps(launches, sort_keys=True)}",
          flush=True)
    missing = [s for s in sites if not launches.get(s)]
    if not taken or not equal or missing:
        raise AssertionError(f"branch {name}: taken={taken} oracle equal="
                             f"{equal} ({len(contigs)} contigs, golden "
                             f"{len(want)}), no launch at {missing}")
    rows.append(dict(name=name, taken=taken, n_contigs=len(contigs),
                     wall_s=wall, launches=launches))
    return launches


def _branches_single(reads, want, circ, circ_want, params, circ_params,
                     rows) -> list[dict]:
    """The single-device fallbacks through run_pipeline: the count's
    capacity retry, the streaming merge, the walk ladder's second rung and
    the dense fallback (walk_m forced small, then empty), the incremental
    update's kill overflow and the final state's tail overflow (module
    constants lowered, then restored), and the cycle fallback on a
    circular genome. Returns compact_flagged held against its plain
    version at the overflowing kills and tails calls."""
    from genome_tpu_torch.assemble import pipeline
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.graph import simplify as simp

    def run(r, p, **kwargs):
        m = Metrics(quiet=True)
        return pipeline.run_pipeline(r, p, metrics=m, device="cuda",
                                     **kwargs)["contigs"], m.events

    def retries(events):
        return sum(e["event"] == "capacity_overflow" for e in events)

    def count_retry():
        contigs, ev = run(reads, params, capacity=1024)
        n = retries(ev)
        return contigs, n and f"capacity_overflow x{n} from capacity 1024"
    _branch("count_retry", count_retry, want, BRANCH_SITES, rows)

    def count_streaming():
        merges = []
        with _patched(_spy(pipeline, "merge_tables", merges,
                           lambda a, k, o: 1)):
            contigs, ev = run(reads, params, capacity=1 << 16,
                              max_device_kmers=1 << 18)
        n = retries(ev)
        return contigs, n and merges and (
            f"streaming count, {len(merges)} merge_tables, "
            f"capacity_overflow x{n} from capacity 65536")
    _branch("count_streaming", count_streaming, want,
            BRANCH_SITES + ("count_merge",), rows)

    base = simp.run_pass_inc
    small, big = 256, simp._WALK_M[-1]

    def walk(ladder):
        walks, dense = [], []
        keep = (lambda a, k, o: (a[-1], bool(o[2])))  # (M, overflow)
        with _patched((simp, "run_pass_inc",
                       functools.partial(base, walk_m=ladder)),
                      _spy(simp, "_tips_body", walks, keep),
                      _spy(simp, "_bubbles_body", walks, keep),
                      _spy(simp, "clip_tips_pass_dense", dense,
                           lambda a, k, o: "tips"),
                      _spy(simp, "pop_bubbles_pass_dense", dense,
                           lambda a, k, o: "bubbles")):
            contigs, _ = run(reads, params)
        return contigs, walks, dense

    def walk_rung2():
        contigs, walks, dense = walk((small, big))
        ovf = sum(m == small and o for m, o in walks)
        fit = sum(m == big and not o for m, o in walks)
        return contigs, ovf and fit and not dense and (
            f"walk_m rung 2: {ovf} passes overflowed M={small}, {fit} fit "
            f"M={big}")
    _branch("walk_rung2", walk_rung2, want, BRANCH_SITES, rows)

    def walk_dense():
        contigs, walks, dense = walk((small,))
        ovf = sum(o for _, o in walks)
        return contigs, ovf and dense and (
            f"dense fallback: {ovf} passes overflowed M={small}, "
            f"{len(dense)} dense passes")
    # a pass whose every rung overflows updates no degrees: no kills
    _branch("walk_dense", walk_dense, want,
            [s for s in BRANCH_SITES if s != "kills"], rows)

    def walk_empty():
        contigs, walks, dense = walk(())
        return contigs, dense and not walks and (
            f"walk_m empty: {len(dense)} dense passes, no walk")
    _branch("walk_empty", walk_empty, want,
            [s for s in BRANCH_SITES if s not in ("tips", "bubbles", "kills")],
            rows)

    overflowing = (lambda flags, cap: int(flags.sum()) > cap)
    held = {}  # the overflowing kills and tails calls' inputs

    def kill_overflow():
        kovf = []
        with _capture_compact(overflowing) as got, \
                _patched((simp, "_KILL_M", 4),
                         _spy(simp, "_update_degrees", kovf,
                              lambda a, k, o: bool(o[4]))):
            contigs, _ = run(reads, params)
        held.update((s, v) for s, v in got.items() if s == "kills")
        n = sum(kovf)
        return contigs, n and "kills" in got and (
            f"_KILL_M=4 overflow in {n} of {len(kovf)} passes")
    _branch("kill_overflow", kill_overflow, want, BRANCH_SITES, rows)

    def tail_overflow():
        with _capture_compact(overflowing) as got, \
                _patched((simp, "_TAIL_M", 2)):
            contigs, _ = run(reads, params)
        if "tails" not in got:
            return contigs, None
        held["tails"] = got["tails"]
        n = int(got["tails"][0].sum())
        return contigs, f"_TAIL_M=2 overflow ({n} tails), full-size twins"
    _branch("tail_overflow", tail_overflow, want, BRANCH_SITES, rows)

    def cycle_fallback():
        oks, dense = [], []
        with _patched(_spy(simp, "_rank_rulers", oks,
                           lambda a, k, o: bool(o[2])),
                      _spy(simp, "_chain_state", dense,
                           lambda a, k, o: len(a) + len(k) == 5)):
            contigs, _ = run(circ, circ_params)
        return contigs, oks == [False] and any(dense) and (
            "cycle fallback: ruler ok=False, the dense chain state")
    _branch("cycle_fallback", cycle_fallback, circ_want,
            [s for s in BRANCH_SITES if s != "tails"], rows)

    shapes = [_shape_row("branch kernels", site, *held.pop(site))
              for site in ("kills", "tails")]
    for r in shapes:
        if r["total"] <= r["capacity"]:
            raise AssertionError(f"branch: {r['site']} did not overflow")
    return shapes


def _branches_dist(reads, want, params, rows) -> None:
    """The sharded path's fallbacks on a one-rank NCCL group, forced as
    the CPU tests force them: _KILL_MD = 2 (degrees recomputed after the
    passes that kill more), _bub_mc = 2 on the slack ladder's first rung
    (one retry), then on every rung (the ladder used up: the replicated
    passes), the emission's buffers too small on every try (the gathered
    emission), and assemble_multihost's replicated escape (the passes'
    route slack starved on every rung)."""
    import torch.distributed as dist
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.dist import assemble_sharded
    from genome_tpu_torch.dist import emit as demit
    from genome_tpu_torch.dist import simplify as dsimp
    from genome_tpu_torch.dist.mesh import init_group
    from genome_tpu_torch.dist.multihost import assemble_multihost

    bub_mc, make_simplify = dsimp._bub_mc, dsimp.make_sharded_simplify

    def sharded(*changes):
        m = Metrics(quiet=True)
        with _patched(*changes):
            contigs = assemble_sharded(reads, params, metrics=m,
                                       device="cuda")
        events = [e["event"] for e in m.events]
        ledger = next(e for e in m.events if e["event"] == "exchange_ledger")
        return contigs, events, ledger

    with tempfile.TemporaryDirectory() as tmp:
        init_group(0, 1, f"file://{tmp}/rendezvous", device="cuda")
        try:
            def kill_md():
                contigs, ev, led = sharded((dsimp, "_KILL_MD", 2))
                n = led["dist_degrees"]["invocations"]
                return contigs, n > 1 and not [e for e in ev if e in
                                               DIST_FALLBACKS] and (
                    f"_KILL_MD=2: dist_degrees ran {n} times, "
                    f"dist_tips {led['dist_tips']['invocations']}")
            _branch("dist_kill_md", kill_md, want, BRANCH_DIST_SITES, rows)

            def bub_rung1():
                contigs, ev, led = sharded((dsimp, "_bub_mc", lambda cl2, sl:
                                            2 if sl < 1.4 else bub_mc(cl2, sl)))
                n = led["dist_bubbles"].get("retry_epochs", 0)
                return contigs, n == 1 and not [e for e in ev if e in
                                                DIST_FALLBACKS] and (
                    "_bub_mc=2 on rung 1: one slack retry, no fallback")
            _branch("dist_bub_rung1", bub_rung1, want, BRANCH_DIST_SITES,
                    rows)

            def bub_all():
                contigs, ev, _ = sharded((dsimp, "_bub_mc",
                                          lambda cl2, sl: 2))
                return contigs, "dist_simplify_overflow_fallback" in ev \
                    and "dist_simplify_overflow_fallback"
            _branch("dist_bub_all", bub_all, want,
                    ("count_heads", "count_filter", "dist_bubble_cands",
                     "tips", "bubbles", "kills", "tails", "contig_starts"),
                    rows)

            def emit_fallback():
                contigs, ev, _ = sharded((demit, "_emit_caps",
                                          lambda cl2, S: (8, 8, 8)))
                return contigs, "dist_emit_overflow_fallback" in ev \
                    and "dist_emit_overflow_fallback"
            _branch("dist_emit_fallback", emit_fallback, want,
                    ("count_heads", "count_filter", "dist_kills",
                     "dist_bubble_cands", "dist_emit_blocks",
                     "contig_starts"), rows)

            def escape():
                pt = {}
                with _patched((dsimp, "make_sharded_simplify",
                               lambda g, cap, slack, *a, **kw: make_simplify(
                                   g, cap, slack / 1000, *a, **kw))):
                    contigs = assemble_multihost(reads, params,
                                                 phase_times=pt,
                                                 device="cuda")
                keys = sorted(pt)
                return contigs, keys == ["build", "count", "extract",
                                         "simplify"] and (
                    f"replicated escape (phase_times {keys})")
            _branch("multihost_escape", escape, want,
                    ("count_heads", "count_filter", "tips", "bubbles",
                     "kills", "tails", "contig_starts"), rows)
        finally:
            dist.destroy_process_group()


def _branch_cli(reads, want, params, rows) -> None:
    """--backend golden and the default device backend on one FASTQ of
    the case's reads: the same FASTA, byte for byte."""
    from genome_tpu_torch.assemble import cli
    from genome_tpu_torch.io import read_fastx

    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "reads.fastq")
        _write_fastq(fq, reads)
        flags = ["--k", str(params.k), "--min-coverage",
                 str(params.min_coverage), "--quiet"]
        gold, dev = os.path.join(td, "g.fasta"), os.path.join(td, "d.fasta")
        metrics = os.path.join(td, "m.jsonl")

        def run():
            if cli.main([fq, "-o", gold, "--backend", "golden", "--metrics",
                         metrics] + flags) or cli.main(
                             [fq, "-o", dev, "--device", "cuda"] + flags):
                raise AssertionError("branch cli_golden: a CLI run failed")
            with open(gold, "rb") as f, open(dev, "rb") as g:
                same = f.read() == g.read()
            with open(metrics) as f:
                ev = [json.loads(line) for line in f]
            phase = any(e["event"] == "phase_end"
                        and e["phase"] == "assemble_golden" for e in ev)
            return read_fastx(gold), same and phase and (
                "assemble_golden phase; --backend golden FASTA == device "
                "FASTA byte for byte")
        _branch("cli_golden", run, want, BRANCH_SITES, rows)


def _branch_build_oracles(w, params, rows) -> None:
    """build_graph_join and build_graph_bsearch against build_graph_kjoin
    on legacy's filtered count table (cut to the pipeline's cap2), tensor
    for tensor, each build timed."""
    import torch
    from genome_tpu_torch.assemble.pipeline import count_reads
    from genome_tpu_torch.graph import build

    res = count_reads(w["err"], params, w["capacity"], device="cuda")
    n_unique = res["n_unique_host"]
    step = max(256, 1 << max(0, n_unique.bit_length() - 6))
    table = res["table"][: -(-n_unique // step) * step]
    del res
    t0 = time.perf_counter()
    walls = {}
    want = None
    for name in ("build_graph_kjoin", "build_graph_join",
                 "build_graph_bsearch"):
        t1 = time.perf_counter()
        got = getattr(build, name)(table, n_unique, params.k)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t1
        if want is None:
            want = got
        elif not (torch.equal(got[0], want[0])
                  and torch.equal(got[1], want[1])):
            raise AssertionError(f"branch build_oracles: {name} != "
                                 "build_graph_kjoin")
        del got
    wall = time.perf_counter() - t0
    print(f"[branch build_oracles] taken=build_graph_join,"
          f"build_graph_bsearch n_contigs=- oracle=equal wall_s={wall:.4f} "
          f"(succ [{want[0].shape[0]}, 4] and okv equal build_graph_kjoin's "
          f"on legacy's table, {n_unique} k-mers; walls "
          + ", ".join(f"{k} {v:.4f} s" for k, v in walls.items()) + ")",
          flush=True)
    rows.append(dict(name="build_oracles", taken="build_graph_join,"
                     "build_graph_bsearch", n_nodes=n_unique, wall_s=wall,
                     build_walls_s=walls))


def phase_branches(w, smi: str) -> dict:
    """Every fallback branch that only CPU tests reached before, on the
    card, each case's contigs held against the port's golden oracle
    (genome_tpu_torch.golden) and each branch proved taken from its
    events or counters: a 100,000 bp genome, 100 bp reads with 1 %
    errors at 30x (k = 21, min_coverage 2), and a 100,000 bp circular
    genome, error-free reads at 30x (min_coverage 1), made from seeds with
    io/simulate.py; and the build oracles on legacy's table."""
    import torch
    from genome_tpu_torch.golden import assemble_golden
    from genome_tpu_torch.io.simulate import random_genome, simulate_reads
    from genome_tpu_torch.params import AssemblyParams

    t0 = time.perf_counter()
    params = AssemblyParams(k=21, min_coverage=2)
    circ_params = AssemblyParams(k=21, min_coverage=1)
    reads = simulate_reads(random_genome(100_000, seed=95), read_len=100,
                           coverage=30, error_rate=0.01, seed=96)
    circ = simulate_reads(random_genome(100_000, seed=97), read_len=100,
                          coverage=30, error_rate=0.0, circular=True,
                          seed=98)
    t1 = time.perf_counter()
    want = assemble_golden(reads, params)
    circ_want = assemble_golden(circ, circ_params)
    oracle_s = time.perf_counter() - t1
    print(f"[branch] golden oracle: {len(reads)} reads -> {len(want)} "
          f"contigs, circular {len(circ)} reads -> {len(circ_want)} "
          f"({len(circ_want[0])} bp), {oracle_s:.2f} s on the host",
          flush=True)
    rows = []
    shapes = _branches_single(reads, want, circ, circ_want, params,
                              circ_params, rows)
    _branches_dist(reads, want, params, rows)
    _branch_cli(reads, want, params, rows)
    _branch_build_oracles(w, params, rows)
    torch.cuda.empty_cache()
    sites = {}
    for r in rows:
        for s, n in r.get("launches", {}).items():
            sites[s] = sites.get(s, 0) + n
    wall = time.perf_counter() - t0
    print(f"[branch] {len(rows)} cases, every branch taken and equal to the "
          f"golden oracle; phase {wall:.1f} s (oracle {oracle_s:.1f} s) | "
          f"{smi}", flush=True)
    return dict(cases=rows, compact_shapes=shapes,
                sites=dict(sorted(sites.items())),
                wall_s=wall, oracle_s=oracle_s)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from genome_tpu_torch.io.benchdata import bench_workload
    from genome_tpu_torch.kernels import compact, cubuild
    from genome_tpu_torch.kernels.keys import SENTINEL
    from genome_tpu_torch.params import AssemblyParams

    # ---- phase 1: device and build ----
    smi = _smi()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {kind} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # g++ beside the nvcc builds
        native = pool.submit(_build_native)
        built = cubuild.build()
        built["fastx_native (g++)"] = native.result()
    print(f"[build] {built} total {time.perf_counter() - t0:.2f} s",
          flush=True)

    # ---- phase 2: kernel vs plain version at the main path's shapes ----
    from genome_tpu_torch.assemble.pipeline import (count_reads, extract_stream,
                                                    run_pipeline)
    params = AssemblyParams(k=21, min_coverage=2)
    legacy = bench_workload(1.0)
    # before any torch.profiler session: one leaves a cost on every later
    # launch, and the ruler ranking is many small launches
    final_rank = phase_final_rank(legacy, params, smi)
    upload = phase_upload(legacy, params.k)
    ext = phase_extract()
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
    stream = extract_stream(legacy["err"], params.k, "cuda")
    keys = torch.cat([stream, stream.new_full((-stream.numel() % BLOCK,),
                                              SENTINEL)])
    brows = phase_bitonic(keys, gen)
    del keys
    hp = phase_hist_partition(stream, gen)
    del stream

    # ---- phase 3: end to end, golden SHA parity ----
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "bench_golden_cache.json")) as f:
        golden = json.load(f)
    phase_e2e("legacy (warm-up)", legacy, params, golden)
    e2e = {"legacy": phase_e2e("legacy", legacy, params, golden)}
    phase_profile("profile legacy", lambda: run_pipeline(
        legacy["err"], params, capacity=legacy["capacity"], device="cuda"),
        e2e["legacy"]["wall_s"])
    native = phase_native_ingest(legacy, params, golden)
    sorter = phase_sorter(legacy, params, golden)
    phase_e2e("legacy bucket", legacy, params, golden, counter="bucket")
    t0 = time.perf_counter()
    phase_e2e("legacy hashtable", legacy, params, golden, counter="hashtable")
    print(f"[e2e] hashtable run took {time.perf_counter() - t0:.1f} s",
          flush=True)
    repeats = bench_workload(1.0, repeats=True)
    e2e["repeats"] = phase_e2e("repeats", repeats, params, golden)
    phase_e2e("repeats bucket", repeats, params, golden, counter="bucket")

    # ---- phase 4: the hash-sharded path, one rank ----
    dist_res = phase_dist(legacy, repeats, params, golden, smi)
    # ---- phase 5: the multi-process entry, one rank ----
    mh = phase_multihost(legacy, params, golden, smi,
                         dist_res["e2e"]["sharded legacy"]["wall_s"],
                         native["timed"]["read_input_s"])
    # ---- phase 6: every fallback branch, against the golden oracle ----
    branches = phase_branches(legacy, smi)
    del legacy, repeats
    launches = {s: sum(r["launches"].get(s, 0) for r in e2e.values())
                for s in compact.SITES}
    print(f"[e2e] launches per site, legacy + repeats: {json.dumps(launches)}",
          flush=True)

    head, ids = rows[0], rows[-1]

    def bitonic_entry(name, line):
        r = brows[name][0]  # the count-site shape the sorter path runs
        return {
            "name": name, "route": "cuda",
            "source": "genome_tpu_torch/kernels/csrc/bitonic.cu",
            "replaces": f"genome_tpu/kernels/bitonic.py:{line}",
            # wrapper calls on the sorter path; each is 6 (sort) or 3
            # (merge) __global__ launches at block 65536
            "launches": sorter["launches"][name],
            "max_abs_err": max(x["max_abs_err"] for x in brows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "matched_plain": True,
            "shapes": brows[name]}

    def hp_entry(name, src, replaces):
        r = hp[name]  # the count-stream shape of its own path
        return {
            "name": name, "route": "cuda",
            "source": f"genome_tpu_torch/kernels/csrc/{src}.cu",
            "replaces": f"genome_tpu/kernels/{replaces}",
            # wrapper calls on its path; each is one memset and one
            # __global__ launch
            "launches": hp["launches"][name], "global_launches_per_call": 1,
            "max_abs_err": max(x["max_abs_err"]
                               for x in r.get("shapes", [r])),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "matched_plain": True,
            **({"device_split": r["split"]} if "split" in r else {}),
            **({"host_us_per_call": r["host_us"]} if "host_us" in r
               else {}),
            "shapes": r.get("shapes", [r])}

    dist_rows = [x for r in dist_res["e2e"].values()
                 for x in r["compact_shapes"]]
    summary = {"kernels": [{
        "name": "compact_flagged", "route": "cuda",
        "source": "genome_tpu_torch/kernels/csrc/compact.cu",
        "replaces": "genome_tpu/kernels/compact.py:177",
        # wrapper calls on the main path; each is one memset and one
        # __global__ launch
        "launches": sum(launches.values()), "global_launches_per_call": 1,
        "host_us_per_call": {"compact_ids": ids["host_us"]},
        "device_split": {r["site"]: r["split"] for r in rows
                         if "split" in r},
        "max_abs_err": max(r["max_abs_err"]
                           for r in rows + dist_rows + mh["compact_shapes"]
                           + branches["compact_shapes"]),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "matched_plain": True,
        "sites": launches, "shapes": rows,
        # the dist path's timed runs (legacy, repeats), counted apart
        "dist_sites": {s: sum(r["launches"].get(s, 0)
                              for r in dist_res["e2e"].values())
                       for s in compact.SITES},
        # held against the plain version on the dist path's own inputs
        "dist_shapes": {w: r["compact_shapes"]
                        for w, r in dist_res["e2e"].items()},
        # assemble_multihost's timed run (legacy), and its sites' inputs
        "multihost_sites": mh["launches"],
        "multihost_shapes": mh["compact_shapes"],
        # the branch phase's runs, summed over its cases, and the
        # overflowing kills and tails calls held against the plain version
        "branch_sites": branches["sites"],
        "branch_shapes": branches["compact_shapes"]},
        bitonic_entry("sort_blocks", 86), bitonic_entry("merge_blocks", 143),
        hp_entry("digit_histogram", "hist", "pallas_hist.py:74"),
        hp_entry("partition_by_bucket", "partition", "partition.py:193"),
        {"name": "extract_canonical_kmers_packed", "route": "cuda",
         "source": "genome_tpu_torch/kernels/csrc/extract.cu",
         # no Pallas kernel: the JAX package extracts with plain jnp
         # wrapper calls on the main path (legacy + repeats); each is
         # one __global__ launch
         "replaces": None,
         "launches": sum(r["extract_launches"] for r in e2e.values()),
         "global_launches_per_call": 1, "max_abs_err": 0,
         "ms": ext["shapes"][0]["ms"],
         "plain_ms": ext["shapes"][0]["plain_ms"],
         "bound_ms": ext["shapes"][0]["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "matched_plain": True,
         "device_split": ext["split"], "shapes": ext["shapes"]}],
        "sort_pairs_merge": brows["sort_pairs_merge"],
        "upload": upload, "native_ingest": native, "dist": dist_res,
        "multihost": {k: v for k, v in mh.items() if k != "compact_shapes"},
        "final_rank": final_rank,
        "branches": {k: v for k, v in branches.items()
                     if k != "compact_shapes"},
        "bitonic_split": brows["split"],
        "count_stream_skew": hp["skew"]}
    print(smi)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
