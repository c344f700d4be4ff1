"""Single-device assembly pipeline (port of
genome_tpu/assemble/pipeline.py).

reads -> codes (host) -> extract + count (device) -> graph build (device)
-> simplify fixpoint (device) -> final chain state (device) -> contigs
(device ordering, host strings). Table capacity is a power of two with an
overflow retry; every phase is timed through Metrics, checkpointed at its
boundary, and optionally traced with torch.profiler.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from genome_tpu_torch.assemble.checkpoint import PhaseCheckpointer
from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.graph.build import build_graph_device
from genome_tpu_torch.graph.contigs import emit_contigs_device
from genome_tpu_torch.graph.simplify import final_chain_state, run_pass_inc
from genome_tpu_torch.kernels.count import (count_kmers_device, filter_table,
                                            merge_tables)
from genome_tpu_torch.kernels.extract import (extract_canonical_kmers,
                                              pack_reads)
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.params import AssemblyParams
from genome_tpu_torch.utils.device import resolve_device

COUNTERS = ("sort",)


def _pow2_at_least(n: int) -> int:
    return 1 << max(13, (max(n, 1) - 1).bit_length())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_counter(counter: str) -> None:
    if counter not in COUNTERS:
        raise NotImplementedError(
            f"counter {counter!r} is not ported to genome_tpu_torch yet "
            "(see ROADMAP.md, modules to port); use counter='sort'")


def extract_stream(reads, k: int, device="cuda", batch_reads: int = 65536,
                   chunk_rows: int = 1 << 21) -> torch.Tensor:
    """Reads -> flat canonical int64 k-mer stream on `device`.

    `reads` is a list of strings (packed to uint8 codes in batches of
    `batch_reads`) or a uint8 code matrix [R, L] (uploaded in chunks of
    `chunk_rows` rows). Rows are uploaded as they are: no row or column
    padding, so the stream holds exactly R * (L - k + 1) windows."""
    dev = resolve_device(device)
    if isinstance(reads, np.ndarray):
        parts = [extract_canonical_kmers(
                    torch.from_numpy(np.ascontiguousarray(
                        reads[i : i + chunk_rows], dtype=np.uint8)).to(dev),
                    k)
                 for i in range(0, reads.shape[0], chunk_rows)]
    else:
        L = max((len(r) for r in reads), default=0)
        parts = [extract_canonical_kmers(
                    torch.from_numpy(pack_reads(reads[i : i + batch_reads],
                                                L)).to(dev), k)
                 for i in range(0, len(reads), batch_reads)]
    if not parts:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def count_reads(reads, params: AssemblyParams, capacity: int | None = None,
                metrics: Metrics | None = None,
                max_device_kmers: int | None = None, counter: str = "sort",
                device="cuda") -> dict:
    """reads -> counted k-mer table dict (count_kmers_device result).

    Doubles the capacity and retries on overflow. Past
    `max_device_kmers` windows, counting streams in chunks whose partial
    tables are merged on the device (threshold applied to the complete
    merged counts only)."""
    _check_counter(counter)
    keys = extract_stream(reads, params.k, device)
    n_windows = int(keys.shape[0])
    if max_device_kmers and n_windows > max_device_kmers:
        return _count_streaming(keys, params, capacity, metrics,
                                max_device_kmers, n_windows)
    cap = capacity or _pow2_at_least(n_windows or 1)
    while True:
        res = count_kmers_device(keys, params.min_coverage, cap)
        # one host round trip for both scalars
        ovf, n_unique = torch.stack([res["overflow"].to(torch.int64),
                                     res["n_unique"]]).tolist()
        if not ovf:
            res["n_windows"] = n_windows
            res["n_unique_host"] = n_unique
            return res
        if metrics:
            metrics.log("capacity_overflow", capacity=cap, retry=2 * cap)
        cap *= 2


def _count_streaming(keys, params, capacity, metrics, chunk: int,
                     n_windows: int) -> dict:
    """Chunked count + on-device table merges (SURVEY §3.2 streaming)."""
    cap = capacity or _pow2_at_least(min(n_windows, 4 * chunk))
    while True:
        running = None
        overflowed = False
        for i in range(0, n_windows, chunk):
            part = keys[i : i + chunk]
            if part.shape[0] < chunk:
                part = torch.cat([part, part.new_full(
                    (chunk - part.shape[0],), SENTINEL)])
            counted = count_kmers_device(part, 1, cap)
            running = counted if running is None else merge_tables(
                running, counted, 1, cap)
            if bool(running["overflow"] | counted["overflow"]):
                overflowed = True
                break
        if not overflowed:
            res = filter_table(running, params.min_coverage)
            res["n_windows"] = n_windows
            return res
        if metrics:
            metrics.log("capacity_overflow", capacity=cap, retry=2 * cap)
        cap *= 2


def simplify_with_metrics(succ, okv, counts, alive, valid_node, params,
                          metrics: Metrics | None = None,
                          with_links: bool = False):
    """Fixpoint loop: tips then bubbles per round (SEMANTICS §5), one
    host round trip per round.

    with_links: also return the final round's (next_u, prev_u) links for
    final_chain_state (None if the loop never reached a clean fixpoint)."""
    links = deg = lc = None
    for rnd in range(params.max_rounds):
        t0 = time.perf_counter()
        alive, c1, _l1, deg, lc = run_pass_inc(
            "tips", succ, okv, counts, alive, valid_node,
            params.tip_len_eff, params.tip_len_eff, deg, lc)
        alive, c2, l2, deg, lc = run_pass_inc(
            "bubbles", succ, okv, counts, alive, valid_node,
            params.bubble_len_eff, params.bubble_len_eff, deg, lc)
        c1b, c2b, n_alive = torch.stack(
            [c1.to(torch.int64), c2.to(torch.int64),
             (alive & valid_node).sum()]).tolist()
        if metrics:
            metrics.log("simplify_round", round=rnd, tips=bool(c1b),
                        bubbles=bool(c2b), alive=n_alive,
                        wall_s=round(time.perf_counter() - t0, 4))
        if not (c1b or c2b):
            links = l2
            break
    return (alive, links) if with_links else alive


@contextlib.contextmanager
def _profiled(profile_dir: str | None, dev: torch.device):
    """torch.profiler over the block; a Chrome trace lands in profile_dir."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def run_pipeline(reads, params: AssemblyParams,
                 capacity: int | None = None,
                 metrics: Metrics | None = None,
                 ckpt: PhaseCheckpointer | None = None,
                 profile_dir: str | None = None,
                 max_device_kmers: int | None = None,
                 counter: str = "sort", device="cuda") -> dict:
    """Full single-device pipeline with metrics/checkpoint/profiling.

    Returns {"contigs": [...], "stats": {...}}."""
    dev = resolve_device(device)
    _check_counter(counter)
    metrics = metrics or Metrics(quiet=True)
    ckpt = ckpt or PhaseCheckpointer(None, params)
    stats: dict = {}

    with _profiled(profile_dir, dev):
        # ---- phase: count ----
        saved = ckpt.load("count")
        if saved is not None:
            metrics.log("resume", phase="count")
            table = torch.from_numpy(saved["table"]).to(dev)
            counts = torch.from_numpy(saved["counts"]).to(dev)
            n_unique = int(saved["n_unique"])
            stats["n_windows"] = int(saved["n_windows"])
        else:
            with metrics.phase("count") as info:
                t0 = time.perf_counter()
                res = count_reads(reads, params, capacity, metrics,
                                  max_device_kmers=max_device_kmers,
                                  counter=counter, device=dev)
                table, counts = res["table"], res["counts"]
                n_unique = res.get("n_unique_host")
                if n_unique is None:
                    n_unique = int(res["n_unique"])
                dt = time.perf_counter() - t0
                stats["n_windows"] = info["n_windows"] = res["n_windows"]
                info["n_unique"] = n_unique
                info["kmers_per_s"] = round(res["n_windows"] / max(dt, 1e-9))
            ckpt.save("count", table=table, counts=counts, n_unique=n_unique,
                      n_windows=stats["n_windows"])
        stats["n_unique"] = n_unique

        # shrink the table toward n_unique (1/64 granularity): build and
        # simplify work scales with capacity, not with real nodes
        step = max(256, 1 << max(0, n_unique.bit_length() - 6))
        cap2 = min(table.shape[0], -(-max(n_unique, 1) // step) * step)
        table, counts = table[:cap2], counts[:cap2]
        valid_node = torch.arange(cap2, device=dev) < n_unique

        # ---- phase: build ----
        with metrics.phase("build") as info:
            succ, okv = build_graph_device(table, n_unique, params.k)
            _sync(dev)
            info["nodes"] = n_unique

        # ---- phase: simplify ----
        saved = ckpt.load("simplify")
        links = None
        if saved is not None and saved["alive"].shape[0] == cap2:
            metrics.log("resume", phase="simplify")
            alive = torch.from_numpy(saved["alive"]).to(dev)
        else:
            with metrics.phase("simplify") as info:
                alive = torch.ones(cap2, dtype=torch.bool, device=dev)
                alive, links = simplify_with_metrics(
                    succ, okv, counts, alive, valid_node, params, metrics,
                    with_links=True)
                info["alive"] = int((alive & valid_node).sum())
            ckpt.save("simplify", alive=alive)
        stats["n_alive"] = int((alive & valid_node).sum())

        # ---- phase: contigs ----
        with metrics.phase("contigs") as info:
            t0 = time.perf_counter()
            fs = final_chain_state(succ, okv, counts, alive, valid_node,
                                   links=links)
            _sync(dev)
            info["final_s"] = round(time.perf_counter() - t0, 4)
            t0 = time.perf_counter()
            contigs = emit_contigs_device(fs, okv, params.k,
                                          params.min_contig_len)
            info["emit_s"] = round(time.perf_counter() - t0, 4)
            info["n_contigs"] = len(contigs)
            info["total_bp"] = sum(map(len, contigs))
    stats["n_contigs"] = len(contigs)
    return {"contigs": contigs, "stats": stats}
