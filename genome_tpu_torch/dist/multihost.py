"""Multi-process assembly (port of genome_tpu/dist/multihost.py; SURVEY.md
§2.3, §3.4).

One process per rank, one rank per card: JAX's processes x local devices
on one mesh become the ranks of one torch.distributed group (NCCL on the
card, gloo on the CPU), and the mesh size is the world size. Each rank
passes its own reads:

    local reads -> extract -> sharded count / build / simplify / final
    state / emission (dist/: no rank holds a global-graph-sized array)
    -> every rank returns the same contigs, or, with out_path, writes
    its slice of them (write_fasta_parallel).

Every branch that depends on a rank's own data (a resume, an overflow
retry, the escape) is agreed over the group first, so every rank takes
it. The replicated path (gather the graph on every rank, simplify there)
is only the escape when a sharded ladder is used up.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import Metrics, count
from genome_tpu_torch.assemble.pipeline import (extract_stream,
                                                simplify_with_metrics)
from genome_tpu_torch.dist.assemble import build_with_retry, count_with_retry
from genome_tpu_torch.dist.emit import (emit_contigs_sharded,
                                        write_fasta_parallel)
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import (all_gather_rows, all_max,
                                        check_device, init_group)
from genome_tpu_torch.dist.simplify import (final_state_sharded,
                                            simplify_sharded)
from genome_tpu_torch.graph.contigs import emit_contigs_device
from genome_tpu_torch.graph.simplify import final_chain_state
from genome_tpu_torch.io.fastx import write_fasta
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.params import AssemblyParams
from genome_tpu_torch.utils.device import resolve_device

# fault injection: "<phase>[:<rank>]" hard-exits that rank (or every
# rank) right after the phase's checkpoint is saved
CRASH_ENV = "GENOME_TPU_CRASH_AFTER"


def initialize(coordinator: str, num_processes: int, process_id: int,
               device="cuda") -> torch.device:
    """Join the job's process group as rank `process_id` of
    `num_processes`; returns the rank's device.

    `coordinator` is JAX's "host:port" (rank 0 listens there: tcp://) or
    a URL such as file:///shared/rendezvous, which passes unchanged. A
    process holds one rank and one device, so JAX's local_device_count
    has no counterpart: run one process per card."""
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    return init_group(process_id, num_processes, init, device)


def _agreed(flag: bool, group) -> bool:
    """True on every rank iff every rank's flag is set."""
    return all_max(int(not flag), group) == 0


def _crash_hook(phase: str, rank: int) -> None:
    want = os.environ.get(CRASH_ENV, "")
    if not want:
        return
    ph, _, pid = want.partition(":")
    if ph == phase and (pid == "" or int(pid) == rank):
        os.write(2, f"[genome_tpu_torch.dist] injected crash after "
                    f"{phase}\n".encode())
        os._exit(7)


def _write_on_rank0(out_path: str, contigs: list[str], group) -> int:
    if dist.get_rank(group) == 0:
        write_fasta(out_path, contigs)
    all_max(0, group)  # no rank returns before the file exists
    return len(contigs)


def assemble_multihost(local_reads, params: AssemblyParams | None = None,
                       local_capacity: int | None = None,
                       forbid_replicated: bool = False,
                       phase_times: dict | None = None, ckpt=None,
                       out_path: str | None = None, group=None,
                       metrics: Metrics | None = None, device="cuda"):
    """SPMD entry: every rank of the group passes its own reads (a list of
    strings or a uint8 code matrix) and gets the full sorted contig list.

    out_path: the FASTA is written by this call and the return value is
    the total contig count. On the sharded emission every rank decodes
    and writes only its 1/P slice (write_fasta_parallel); on a fallback
    rank 0 writes. The ranks share a file system.

    forbid_replicated: raise instead of taking the replicated escape.
    phase_times: filled with wall seconds per phase (extract, count,
    build, simplify, final, emit, write) and, on the sharded path, the
    call's exchange ledger with the fast final's rounds.
    metrics: this rank's Metrics. The call runs in assemble_sharded's
    phases (dist_extract, dist_count, dist_build, dist_simplify_sharded,
    dist_final_sharded, dist_contigs; dist_simplify on the escape), so
    the spans and counters below them land there: the exchanges'
    `dist.exchange` spans, `exchange_bytes` and `collectives` (dist/
    mesh.py), `retries` (each capacity, query, slack-ladder or emission
    redo) and `escapes` (each gathered or replicated fallback taken).
    ckpt: a PhaseCheckpointer of this rank's shard. Each rank saves its
    part of the count, build and simplify artifacts; on a restart a
    phase is skipped only when every rank holds a matching artifact, and
    a build (simplify) only on top of a skipped count (build). The
    environment variable GENOME_TPU_CRASH_AFTER="<phase>[:<rank>]" exits
    that rank (code 7) right after the phase's artifact is saved.
    `device` is the rank's device and must match the group's backend."""
    params = params or AssemblyParams()
    metrics = metrics or Metrics(quiet=True)
    pt = phase_times if phase_times is not None else {}
    dev = resolve_device(device)
    check_device(dev, group)
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    ledger = ExchangeLedger()

    def mark(name, t0):
        pt[name] = pt.get(name, 0.0) + (time.perf_counter() - t0)

    def load(name, ck):
        return torch.from_numpy(ck[name]).to(dev)

    def meta(cap):
        return np.asarray([cap], np.int64)

    # count (a resumed count skips the extraction too: its only consumer)
    with metrics.phase("dist_extract") as info:
        ck = ckpt.load("dist_count") if ckpt is not None else None
        count_resumed = _agreed(ck is not None, group)
        if not count_resumed:
            t0 = time.perf_counter()
            stream = extract_stream(local_reads, params.k, dev)
            m = all_max(max(stream.numel(), 1), group)
            if m > stream.numel():
                stream = torch.cat([stream, stream.new_full(
                    (m - stream.numel(),), SENTINEL)])
            info["windows"] = S * m
            mark("extract", t0)
    with metrics.phase("dist_count") as info:
        if count_resumed:
            local_cap = int(ck["meta"][0])
            table, counts = load("table", ck), load("counts", ck)
            n_unique = int(ck["n_unique"][0])
        else:
            t0 = time.perf_counter()
            table, counts, n_unique, local_cap = count_with_retry(
                stream, params.min_coverage, local_capacity, group, ledger,
                metrics)
            del stream
            mark("count", t0)
            if ckpt is not None:
                ckpt.save("dist_count", table=table, counts=counts,
                          n_unique=np.asarray([n_unique], np.int64),
                          meta=meta(local_cap))
                _crash_hook("dist_count", rank)
        info["n_unique"] = n_unique
        info["local_cap"] = local_cap

    # build (resumes only on a resumed count: only then is the table
    # layout known to match the saved one)
    with metrics.phase("dist_build") as info:
        ck = (ckpt.load("dist_build")
              if ckpt is not None and count_resumed else None)
        build_resumed = _agreed(
            ck is not None and int(ck["meta"][0]) == local_cap, group)
        if build_resumed:
            succ, okv = load("succ", ck), load("okv", ck)
        else:
            t0 = time.perf_counter()
            succ, okv, info["query_cap"] = build_with_retry(
                table, n_unique, params.k, local_cap, group, ledger, metrics)
            mark("build", t0)
            if ckpt is not None:
                ckpt.save("dist_build", succ=succ, okv=okv,
                          meta=meta(local_cap))
                _crash_hook("dist_build", rank)
        del table

    # sharded tip and bubble passes
    with metrics.phase("dist_simplify_sharded") as info:
        ck = (ckpt.load("dist_simplify")
              if ckpt is not None and build_resumed else None)
        if _agreed(ck is not None and int(ck["meta"][0]) == local_cap,
                   group):
            alive_sh, ovf_s = load("alive", ck), False
        else:
            t0 = time.perf_counter()
            alive_sh, ovf_s = simplify_sharded(
                succ, okv, counts,
                torch.ones(local_cap, dtype=torch.bool, device=dev),
                n_unique, params, group, ledger)
            mark("simplify", t0)
            if ckpt is not None and not ovf_s:
                ckpt.save("dist_simplify", alive=alive_sh,
                          meta=meta(local_cap))
                _crash_hook("dist_simplify", rank)
        info["overflow"] = ovf_s
        count("escapes", int(ovf_s))
        if ovf_s:
            metrics.log("dist_simplify_overflow_fallback")

    if not ovf_s:
        # sharded final state; only the emission's fixed-capacity outputs
        # are gathered
        n_events = len(metrics.events)
        with metrics.phase("dist_final_sharded") as info:
            t0 = time.perf_counter()
            head, dist_, primary, alive_o, f_ovf = final_state_sharded(
                succ, okv, counts, alive_sh, n_unique, group, metrics,
                ledger)
            mark("final", t0)
            info["overflow"] = f_ovf
            count("escapes", int(f_ovf))
            if f_ovf:
                metrics.log("dist_final_overflow_fallback")
        if not f_ovf:
            with metrics.phase("dist_contigs") as info:
                # with out_path each rank decodes only its 1/P contig slice
                t0 = time.perf_counter()
                contigs, ok = emit_contigs_sharded(
                    head, dist_, primary, alive_o, okv, params.k,
                    params.min_contig_len, group, ledger,
                    local_slice=(rank, S) if out_path is not None else None)
                count("escapes", int(not ok))
                if not ok:
                    metrics.log("dist_emit_overflow_fallback")
                    fs = dict(head=all_gather_rows(head, group),
                              dist=all_gather_rows(dist_, group),
                              primary=all_gather_rows(primary, group),
                              alive_o=all_gather_rows(alive_o, group))
                    contigs = emit_contigs_device(
                        fs, all_gather_rows(okv, group), params.k,
                        params.min_contig_len, node_primary=True)
                mark("emit", t0)
                rounds = next((dict(p1=e["p1"], p2=e["p2"])
                               for e in metrics.events[n_events:]
                               if e["event"] == "dist_final_fast_rounds"),
                              {})
                pt["exchange_ledger"] = dict(ledger.summary(),
                                             final_fast_rounds=rounds)
                if out_path is None:
                    info["n_contigs"] = len(contigs)
                    return contigs
                t0 = time.perf_counter()
                if ok:
                    total = write_fasta_parallel(out_path, contigs, group)
                else:
                    total = _write_on_rank0(out_path, contigs, group)
                mark("write", t0)
                info["n_contigs"] = total
                return total
        del head, dist_, primary, alive_o

    if forbid_replicated:
        raise RuntimeError(
            "sharded simplify/final overflowed after all retries and the "
            "replicated correctness escape is forbidden")

    # correctness escape: every rank gathers the graph and runs the
    # single-device passes from an all-true mask (also when only the
    # final state overflowed, as the reference does)
    with metrics.phase("dist_simplify") as info:
        succ = all_gather_rows(succ, group)
        okv = all_gather_rows(okv, group)
        counts = all_gather_rows(counts, group)
        n_all = all_gather_rows(
            torch.tensor([n_unique], dtype=torch.int64, device=dev), group)
        valid = (torch.arange(local_cap, device=dev)[None, :]
                 < n_all[:, None]).reshape(-1)
        alive = torch.ones(S * local_cap, dtype=torch.bool, device=dev)
        alive, links = simplify_with_metrics(succ, okv, counts, alive, valid,
                                             params, metrics, with_links=True)
        fs = final_chain_state(succ, okv, counts, alive, valid, links=links)
    with metrics.phase("dist_contigs") as info:
        contigs = emit_contigs_device(fs, okv, params.k,
                                      params.min_contig_len)
        info["n_contigs"] = len(contigs)
        if out_path is not None:
            return _write_on_rank0(out_path, contigs, group)
    return contigs
