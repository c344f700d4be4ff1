"""Single-device assembly pipeline (port of
genome_tpu/assemble/pipeline.py).

reads -> codes (host) -> packed upload -> extract + count (device) -> graph
build (device) -> simplify fixpoint (device) -> final chain state (device)
-> contigs (device ordering, host strings). Table capacity is a power of
two with an overflow retry; every phase is timed through Metrics,
checkpointed at its boundary, and optionally traced with torch.profiler.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import numpy as np
import torch

from genome_tpu_torch.assemble.checkpoint import PhaseCheckpointer
from genome_tpu_torch.assemble.metrics import (Metrics, count, host_read,
                                                span)
from genome_tpu_torch.graph.build import build_graph_device
from genome_tpu_torch.graph.contigs import emit_contigs_device
from genome_tpu_torch.graph import simplify as graph_simplify
from genome_tpu_torch.graph.simplify import final_chain_state
from genome_tpu_torch.kernels.count import (count_kmers_device, filter_table,
                                            merge_tables)
from genome_tpu_torch.kernels.extract import (
    extract_canonical_kmers_packed, pack_codes_host, pack_reads)
from genome_tpu_torch.kernels.hash_table import count_kmers_hashtable
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.kernels.sort_bucket import (count_kmers_bucket,
                                                  default_seg)
from genome_tpu_torch.params import AssemblyParams
from genome_tpu_torch.utils.device import resolve_device

COUNTERS = ("sort", "bucket", "hashtable")


def _pow2_at_least(n: int) -> int:
    return 1 << max(13, (max(n, 1) - 1).bit_length())


def _sync(dev: torch.device, site: str) -> None:
    if dev.type == "cuda":
        host_read(site, lambda: torch.cuda.synchronize(dev))


def _check_counter(counter: str) -> None:
    if counter not in COUNTERS:
        raise ValueError(f"unknown counter {counter!r}; one of {COUNTERS}")


def _counter_fn(counter: str, k: int, seg: int = 0):
    """(keys, min_coverage, capacity) -> table dict for one counter name;
    seg is the bucket counter's region size (0: its default)."""
    if counter == "bucket":
        return functools.partial(count_kmers_bucket, k=k, seg=seg)
    if counter == "hashtable":
        return count_kmers_hashtable
    return count_kmers_device


def extract_stream(reads, k: int, device="cuda", batch_reads: int = 65536,
                   chunk_rows: int = 1 << 18) -> torch.Tensor:
    """Reads -> flat canonical int64 k-mer stream on `device`.

    `reads` is a list of strings (made into uint8 codes in batches of
    `batch_reads`) or a uint8 code matrix [R, L] (in chunks of
    `chunk_rows` rows). Each batch or chunk is packed, uploaded and
    extracted by _extract_codes straight into its slice of the one
    stream; the host packs a chunk while the device extracts the one
    before (chip_smoke.py's `[upload]` lines time it against one chunk).
    Rows are uploaded as they are: no row or column padding, so the
    stream holds exactly R * (L - k + 1) windows."""
    dev = resolve_device(device)
    matrix = isinstance(reads, np.ndarray)
    if matrix:
        (R, L), step = reads.shape, chunk_rows
    else:
        R, step = len(reads), batch_reads
        L = max((len(r) for r in reads), default=0)
    nwin = max(L - k + 1, 0)
    with span("count.extract", device=dev):
        stream = torch.empty(R * nwin, dtype=torch.int64, device=dev)
        for i in range(0, R if nwin else 0, step):
            codes = reads[i : i + step] if matrix else pack_reads(
                reads[i : i + step], L)
            _extract_codes(codes, k, dev,
                           stream[i * nwin : (i + codes.shape[0]) * nwin])
    return stream


def _extract_codes(codes: np.ndarray, k: int, dev: torch.device,
                   out: torch.Tensor) -> None:
    """One chunk of a code matrix -> its keys, written into `out`. The
    native packer writes 4 codes a byte (and the validity mask) straight
    into host tensors, pinned for a CUDA device, which are copied without
    blocking; the mask is uploaded only when a real code is >= 4. Each
    chunk gets new pinned tensors: the caching host allocator hands a
    block out again only after the copy that read it has finished."""
    cuda = dev.type == "cuda"
    with span("count.pack"):
        packed, invalid, has_invalid = pack_codes_host(codes,
                                                       pin_memory=cuda)
    if cuda:
        count("h2d_bytes", packed.nbytes + has_invalid * invalid.nbytes)
    count("extract_chunks")
    packed = packed.to(dev, non_blocking=cuda)
    invalid = invalid.to(dev, non_blocking=cuda) if has_invalid else None
    extract_canonical_kmers_packed(packed, invalid, k, codes.shape[1], out)


def count_reads(reads, params: AssemblyParams, capacity: int | None = None,
                metrics: Metrics | None = None,
                max_device_kmers: int | None = None, counter: str = "sort",
                device="cuda") -> dict:
    """reads -> counted k-mer table dict (count_kmers_device result).

    counter: "sort" (torch.sort + run-length encoding), "bucket"
    (kernels/sort_bucket.py) or "hashtable" (kernels/hash_table.py; the
    capacity is rounded up to a power of two). Doubles the capacity (and
    the bucket region size) and retries on overflow. Past
    `max_device_kmers` windows, counting streams in chunks whose partial
    tables are merged on the device (threshold applied to the complete
    merged counts only)."""
    _check_counter(counter)
    keys = extract_stream(reads, params.k, device)
    n_windows = int(keys.shape[0])
    if max_device_kmers and n_windows > max_device_kmers:
        return _count_streaming(keys, params, capacity, metrics,
                                max_device_kmers, n_windows, counter)
    cap = capacity or _pow2_at_least(n_windows or 1)
    if counter == "hashtable":
        cap = _pow2_at_least(cap)
    seg = default_seg(n_windows or 1)
    while True:
        res = _counter_fn(counter, params.k, seg)(keys, params.min_coverage,
                                                  cap)
        # one host round trip for both scalars
        ovf, n_unique = host_read("count.overflow", lambda: torch.stack(
            [res["overflow"].to(torch.int64), res["n_unique"]]).tolist())
        if not ovf:
            res["n_windows"] = n_windows
            res["n_unique_host"] = n_unique
            return res
        count("retries")
        if metrics:
            metrics.log("capacity_overflow", capacity=cap, retry=2 * cap)
        cap *= 2
        seg *= 2


def _count_streaming(keys, params, capacity, metrics, chunk: int,
                     n_windows: int, counter: str = "sort") -> dict:
    """Chunked count + on-device table merges (SURVEY §3.2 streaming)."""
    chunk_fn = _counter_fn(counter, params.k)
    cap = capacity or _pow2_at_least(min(n_windows, 4 * chunk))
    while True:
        running = None
        overflowed = False
        for i in range(0, n_windows, chunk):
            part = keys[i : i + chunk]
            if part.shape[0] < chunk:
                part = torch.cat([part, part.new_full(
                    (chunk - part.shape[0],), SENTINEL)])
            counted = chunk_fn(part, 1, cap)
            running = counted if running is None else merge_tables(
                running, counted, 1, cap)
            if host_read("count.chunk_overflow", lambda: bool(
                    running["overflow"] | counted["overflow"])):
                overflowed = True
                break
        if not overflowed:
            res = filter_table(running, params.min_coverage)
            res["n_windows"] = n_windows
            return res
        count("retries")
        if metrics:
            metrics.log("capacity_overflow", capacity=cap, retry=2 * cap)
        cap *= 2


def simplify_with_metrics(succ, okv, counts, alive, valid_node, params,
                          metrics: Metrics | None = None,
                          with_links: bool = False):
    """graph.simplify.simplify_device, the fixpoint loop, with a
    `simplify_round` event a round in `metrics` (its changed flags, the
    alive count and the wall).

    with_links: also return the final round's (next_u, prev_u) links for
    final_chain_state (None if the loop never reached a clean fixpoint)."""
    on_round = functools.partial(metrics.log, "simplify_round") \
        if metrics else None
    return graph_simplify.simplify_device(succ, okv, counts, alive,
                                          valid_node, params, with_links,
                                          on_round)


PROFILE_ANNOTATION = "run_pipeline"
_PROLOGUE_ROUNDS = 8  # a pinned copy, a kernel and a fill each
_PROFILE_MARGIN_S = 0.2


@contextlib.contextmanager
def _profiled(profile_dir: str | None, dev: torch.device):
    """torch.profiler over the block, which is the PROFILE_ANNOTATION
    range; a Chrome trace lands in profile_dir. On the card the profiler
    loses the device records of a session's first calls
    (scripts/torch_profiler_probe.py), so the session opens with a
    prologue of copies, kernels and fills that nothing reads, a sync and a
    short wait, and waits again after the block."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            host = torch.zeros(1024, dtype=torch.uint8).pin_memory()
            for _ in range(_PROLOGUE_ROUNDS):
                host.to(dev, non_blocking=True).add_(1).zero_()
            torch.cuda.synchronize(dev)
            time.sleep(_PROFILE_MARGIN_S)
        with record_function(PROFILE_ANNOTATION):
            yield
        if cuda:
            torch.cuda.synchronize(dev)
            time.sleep(_PROFILE_MARGIN_S)
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
                with span("count.reads") as sp:
                    res = count_reads(reads, params, capacity, metrics,
                                      max_device_kmers=max_device_kmers,
                                      counter=counter, device=dev)
                    table, counts = res["table"], res["counts"]
                    n_unique = res.get("n_unique_host")
                    if n_unique is None:
                        n_unique = host_read("count.n_unique",
                                             lambda: int(res["n_unique"]))
                stats["n_windows"] = info["n_windows"] = res["n_windows"]
                info["n_unique"] = n_unique
                info["kmers_per_s"] = round(res["n_windows"]
                                            / max(sp.wall_s, 1e-9))
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
            _sync(dev, "build.sync")
            info["nodes"] = n_unique

        # ---- phase: simplify ----
        saved = ckpt.load("simplify")
        links = None
        if saved is not None and saved["alive"].shape[0] == cap2:
            metrics.log("resume", phase="simplify")
            alive = torch.from_numpy(saved["alive"]).to(dev)
            n_alive = host_read("simplify.alive",
                                lambda: int((alive & valid_node).sum()))
        else:
            with metrics.phase("simplify") as info:
                alive = torch.ones(cap2, dtype=torch.bool, device=dev)
                alive, links = simplify_with_metrics(
                    succ, okv, counts, alive, valid_node, params, metrics,
                    with_links=True)
                n_alive = info["alive"] = host_read(
                    "simplify.alive", lambda: int((alive & valid_node).sum()))
            ckpt.save("simplify", alive=alive)
        stats["n_alive"] = n_alive

        # ---- phase: contigs ----
        with metrics.phase("contigs") as info:
            with span("final") as sp:
                fs = final_chain_state(succ, okv, counts, alive, valid_node,
                                       links=links)
                _sync(dev, "final.sync")
            info["final_s"] = round(sp.wall_s, 6)
            with span("emit") as sp:
                contigs = emit_contigs_device(fs, okv, params.k,
                                              params.min_contig_len)
            info["emit_s"] = round(sp.wall_s, 6)
            info["n_contigs"] = len(contigs)
            info["total_bp"] = sum(map(len, contigs))
    stats["n_contigs"] = len(contigs)
    return {"contigs": contigs, "stats": stats}


# the JAX pipeline's name for the same loop
simplify_device = simplify_with_metrics


def assemble_device(reads, params: AssemblyParams | None = None,
                    capacity: int | None = None, device="cuda") -> list[str]:
    """reads -> sorted canonical contigs on `device`; equal to the golden
    oracle's (SEMANTICS.md)."""
    return run_pipeline(reads, params or AssemblyParams(), capacity=capacity,
                        device=device)["contigs"]
