"""Partitioned assembly (port of genome_tpu/dist/assemble.py).

reads --split--> per-rank extraction
      --all_to_all #1--> sharded count at the k-mer owners
      --all_to_all #2/#3--> sharded graph build (boundary probes, replies)
      --> sharded simplify (dist/simplify.py: remote-gather pointer
          doubling) --> sharded final state (ruler ranking, the exact
          final on a surviving cycle) --> sharded emission (dist/emit.py:
          blocks routed by hash(head, dist // BLOCK)).

After the count no rank holds an array of the global graph's size. Each
sharded stage has JAX's fallback: a used-up slack ladder of the passes
or of the final state gathers the graph on every rank for the
single-device passes or final state; an emission that overflows every
try emits from the gathered final state.

SPMD: every rank of the group calls assemble_sharded with the same reads
and gets the same contigs. Every pin is k-mer-value-based, so the contigs
equal the single-device pipeline's for every shard count.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import Metrics, count
from genome_tpu_torch.assemble.pipeline import (_pow2_at_least,
                                                extract_stream,
                                                simplify_with_metrics)
from genome_tpu_torch.dist.build import sharded_build
from genome_tpu_torch.dist.count import sharded_count, shrink_tables
from genome_tpu_torch.dist.emit import emit_contigs_sharded
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import all_gather_rows, all_max, check_device
from genome_tpu_torch.dist.simplify import (final_state_sharded,
                                            simplify_sharded)
from genome_tpu_torch.graph.contigs import emit_contigs_device
from genome_tpu_torch.graph.simplify import final_chain_state
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.params import AssemblyParams
from genome_tpu_torch.utils.device import resolve_device


def shard_reads(reads, num_shards: int) -> list:
    """Contiguous split of a read list or of a code matrix's rows into
    num_shards parts (the contigs do not depend on the split)."""
    per = (len(reads) + num_shards - 1) // num_shards
    return [reads[i * per : (i + 1) * per] for i in range(num_shards)]


def count_with_retry(stream: torch.Tensor, min_coverage: int,
                     local_capacity: int | None, group,
                     ledger: ExchangeLedger, metrics: Metrics):
    """The sharded count of this rank's window stream (padded to the
    agreed length), retried with both caps doubled while any rank
    overflows, then shrink_tables. Returns (table, counts, n_unique (a
    host int), local_cap)."""
    S = dist.get_world_size(group)
    m_local = stream.numel()
    bucket_cap = max(64, int(1.3 * m_local / S) + 64)
    local_cap = local_capacity or _pow2_at_least(max(64, m_local))
    while True:
        res = sharded_count(stream, min_coverage, bucket_cap, local_cap,
                            group, ledger)
        ledger.invoke("dist_count")
        if not res["overflow"]:
            break
        bucket_cap *= 2
        local_cap *= 2
        count("retries")
        metrics.log("dist_capacity_overflow", bucket_cap=bucket_cap,
                    local_cap=local_cap)
    n_unique = int(res["n_unique"])
    table, counts, local_cap = shrink_tables(local_cap, res["table"],
                                             res["counts"], n_unique, group)
    return table, counts, n_unique, local_cap


def build_with_retry(table: torch.Tensor, n_unique: int, k: int,
                     local_cap: int, group, ledger: ExchangeLedger,
                     metrics: Metrics):
    """The sharded build, retried with the query cap doubled while any
    rank overflows. Returns (succ, okv, query_cap)."""
    S = dist.get_world_size(group)
    query_cap = max(64, int(1.3 * 8 * local_cap / S) + 64)
    while True:
        succ, okv, ovf = sharded_build(table, n_unique, k, local_cap,
                                       query_cap, group, ledger)
        ledger.invoke("dist_build")
        if not ovf:
            return succ, okv, query_cap
        query_cap *= 2
        count("retries")
        metrics.log("dist_query_overflow", query_cap=query_cap)


def assemble_sharded(reads, params: AssemblyParams | None = None,
                     num_shards: int | None = None, group=None,
                     metrics: Metrics | None = None,
                     local_capacity: int | None = None,
                     sharded_simplify: bool = True,
                     device="cuda") -> list[str]:
    """Partitioned assembly over the process group; every rank passes the
    same reads and returns the same sorted contigs, equal to the
    single-device pipeline's.

    The count and the build run sharded. With sharded_simplify (the
    default, as in JAX) the tip and bubble passes, the final state and
    the emission run sharded too: phases dist_simplify_sharded,
    dist_final_sharded, dist_contigs. A used-up ladder of the passes or
    of the final state gathers the graph and the alive mask on every
    rank for the replicated passes or final state (phases dist_simplify,
    dist_contigs); an emission that overflows every try emits from the
    gathered final state. Without sharded_simplify every rank runs the
    replicated passes on the gathered graph. `device` is the rank's
    device and must match the group's backend (a CUDA device with NCCL,
    the CPU with gloo)."""
    params = params or AssemblyParams()
    metrics = metrics or Metrics(quiet=True)
    dev = resolve_device(device)
    check_device(dev, group)
    S, rank = dist.get_world_size(group), dist.get_rank(group)
    if num_shards is not None and num_shards != S:
        raise ValueError(f"num_shards={num_shards} but the group has {S} "
                         "ranks")
    ledger = ExchangeLedger()

    with metrics.phase("dist_extract") as info:
        stream = extract_stream(shard_reads(reads, S)[rank], params.k, dev)
        m_local = max(all_max(stream.numel(), group), 8)
        stream = torch.cat([stream, stream.new_full(
            (m_local - stream.numel(),), SENTINEL)])
        info["windows"] = S * m_local

    # sharded count (all_to_all #1), capacity retry on overflow
    with metrics.phase("dist_count") as info:
        table, counts, n_unique, local_cap = count_with_retry(
            stream, params.min_coverage, local_capacity, group, ledger,
            metrics)
        del stream
        n_all = all_gather_rows(
            torch.tensor([n_unique], dtype=torch.int64, device=dev), group)
        info["n_unique_total"] = int(n_all.sum())
        info["local_cap"] = local_cap

    # sharded build (all_to_all #2/#3: boundary probes and replies)
    with metrics.phase("dist_build") as info:
        succ, okv, info["query_cap"] = build_with_retry(
            table, n_unique, params.k, local_cap, group, ledger, metrics)

    # sharded simplify: the passes retry up the slack ladder on a route
    # overflow; only a used-up ladder falls back to the replicated passes
    alive_sh = None
    if sharded_simplify:
        with metrics.phase("dist_simplify_sharded") as info:
            alive0 = torch.ones(local_cap, dtype=torch.bool, device=dev)
            alive_sh, ovf = simplify_sharded(succ, okv, counts, alive0,
                                             n_unique, params, group, ledger)
            info["overflow"] = ovf
            if ovf:
                alive_sh = None
                metrics.log("dist_simplify_overflow_fallback")

    if alive_sh is not None:
        # the final state stays sharded (no rank holds a global-graph
        # array); only the emission's fixed-capacity outputs are gathered
        with metrics.phase("dist_final_sharded") as info:
            head, dist_, primary, alive_o, f_ovf = final_state_sharded(
                succ, okv, counts, alive_sh, n_unique, group, metrics,
                ledger)
            info["overflow"] = f_ovf
        if not f_ovf:
            with metrics.phase("dist_contigs") as info:
                contigs, ok = emit_contigs_sharded(
                    head, dist_, primary, alive_o, okv, params.k,
                    params.min_contig_len, group, ledger)
                if not ok:
                    metrics.log("dist_emit_overflow_fallback")
                    fs = dict(head=all_gather_rows(head, group),
                              dist=all_gather_rows(dist_, group),
                              primary=all_gather_rows(primary, group),
                              alive_o=all_gather_rows(alive_o, group))
                    contigs = emit_contigs_device(
                        fs, all_gather_rows(okv, group), params.k,
                        params.min_contig_len, node_primary=True)
                info["n_contigs"] = len(contigs)
            metrics.log("exchange_ledger", **ledger.summary())
            return contigs
        del head, dist_, primary, alive_o
        metrics.log("dist_final_overflow_fallback")

    # every rank holds the gathered graph. Rows past each rank's n_unique
    # are invalid, so the valid mask has a hole at the tail of every
    # shard; `alive` counts alive & valid, not the holes (JAX counts
    # every slot)
    with metrics.phase("dist_simplify") as info:
        succ = all_gather_rows(succ, group)
        okv = all_gather_rows(okv, group)
        counts = all_gather_rows(counts, group)
        valid = (torch.arange(local_cap, device=dev)[None, :]
                 < n_all[:, None]).reshape(-1)
        if alive_sh is None:
            alive = torch.ones(S * local_cap, dtype=torch.bool, device=dev)
            alive, links = simplify_with_metrics(
                succ, okv, counts, alive, valid, params, metrics,
                with_links=True)
        else:
            alive, links = all_gather_rows(alive_sh, group), None
        fs = final_chain_state(succ, okv, counts, alive, valid, links=links)
        info["alive"] = int((alive & valid).sum())

    with metrics.phase("dist_contigs") as info:
        contigs = emit_contigs_device(fs, okv, params.k,
                                      params.min_contig_len)
        info["n_contigs"] = len(contigs)
    metrics.log("exchange_ledger", **ledger.summary())
    return contigs
