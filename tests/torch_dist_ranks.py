"""Per-rank bodies for tests/test_torch_dist.py and
tests/test_torch_dist_final.py, run by genome_tpu_torch.dist.run_local in
spawned processes. This module imports
only the port (no JAX), so a rank starts quickly and never touches JAX."""

import contextlib
import importlib

import numpy as np
import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.assemble.pipeline import extract_stream
from genome_tpu_torch.dist import assemble_sharded, shard_reads
from genome_tpu_torch.dist import emit as demit
from genome_tpu_torch.dist import simplify as dsimplify
from genome_tpu_torch.dist.build import sharded_build
from genome_tpu_torch.dist.count import sharded_count
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.kernels.keys import SENTINEL

OPS_WIDTH = 64  # ids a rank in the remote_gather / seg_route checks
_BUB_MC = dsimplify._bub_mc


def tiny_bub_mc_first_rung(cl2, slack):
    """_bub_mc override: 2 candidate slots on the ladder's first rung."""
    return 2 if slack < 1.4 else _BUB_MC(cl2, slack)


def tiny_bub_mc(cl2, slack):
    """_bub_mc override: 2 candidate slots on every rung."""
    return 2


def ops_case(seed, S, rank):
    """The global arrays (the same on every rank) and this rank's requests
    and records of the remote_gather / seg_route checks: ids with
    duplicates, invalid slots (some negative) and owner-local ids."""
    w = OPS_WIDTH
    g = np.random.default_rng(seed)
    v32 = g.integers(-2**31, 2**31 - 1, S * w, dtype=np.int64).astype(
        np.int32)
    v64 = g.integers(-2**62, 2**62, S * w, dtype=np.int64)
    r = np.random.default_rng(seed * 1000 + rank)
    m = 3 * w
    pool = r.integers(0, S * w, 12)
    idx = np.where(r.random(m) < 0.5, r.choice(pool, m),
                   r.integers(0, S * w, m))
    idx[: w // 4] = rank * w + np.arange(w // 4)  # owner-local, self ids
    valid = r.random(m) < 0.8
    idx[~valid & (r.random(m) < 0.5)] = -3
    d64 = r.integers(-100, 100, m)  # per-slot defaults
    vals = np.stack([r.integers(-1000, 1000, m),      # max
                     r.integers(0, 1 << 40, m),       # sum (int64)
                     r.integers(-2**62, 2**62, m)])   # min (int64)
    return dict(v32=v32, v64=v64, idx=idx.astype(np.int32), valid=valid,
                d64=d64, vals=vals)


def _ops(seed):
    """remote_gather and seg_route on this rank's ops_case: the gathers at
    a roomy cap and at cap 1 (overflow), the routed records."""
    S, rank = dist.get_world_size(), dist.get_rank()
    c = ops_case(seed, S, rank)
    w = OPS_WIDTH
    rg, seg_route = dsimplify.make_ops(None, w)
    mine = slice(rank * w, (rank + 1) * w)
    t = {k: torch.from_numpy(np.ascontiguousarray(c[k]))
         for k in ("idx", "valid", "d64", "vals")}
    local = (torch.from_numpy(c["v32"][mine].copy()),
             torch.from_numpy(c["v64"][mine].copy()))
    (o32, o64), ovf = rg(local, t["idx"], t["valid"], 3 * w + 64,
                         (-7, t["d64"]))
    _, ovf1 = rg(local, t["idx"], t["valid"], 1, (-7, t["d64"]))
    lseg, routed, present, sovf = seg_route(
        (t["vals"][0].to(torch.int32), t["vals"][1], t["vals"][2]),
        ("max", "sum", "min"), t["idx"], t["valid"], 3 * w + 64)
    return dict(o32=o32.numpy(), o64=o64.numpy(), ovf=bool(ovf),
                ovf1=bool(ovf1), lseg=lseg.numpy(), present=present.numpy(),
                routed=[x.numpy() for x in routed], seg_ovf=bool(sovf))


def _sharded_simplify(graph, params):
    """simplify_sharded on this rank's part of a graph (succ, okv, counts,
    n_unique), with a fresh ledger."""
    succ, okv, counts, n_unique = graph
    ledger = ExchangeLedger()
    alive, ovf = dsimplify.simplify_sharded(
        torch.from_numpy(succ), torch.from_numpy(okv),
        torch.from_numpy(counts),
        torch.ones(counts.shape[0], dtype=torch.bool), n_unique, params,
        ledger=ledger)
    return dict(alive=alive.numpy(), overflow=ovf, ledger=ledger.summary())


def parity(reads, k, min_cov, pad_to, bucket_caps, local_cap, query_caps,
           jobs, simplify):
    """This rank's count at each bucket cap (its window stream padded to
    pad_to), its build at each query cap (from the first count's table),
    and assemble_sharded on each job (name, reads, params, kwargs; the
    kwarg `overrides` sets dist/simplify.py module names for the job).
    `simplify`: {"graphs": {name: (one (succ, okv, counts, n_unique) a
    rank, params)}} for simplify_sharded, "ops_seed" (or None) for the
    remote_gather / seg_route checks."""
    S, rank = dist.get_world_size(), dist.get_rank()
    stream = extract_stream(shard_reads(reads, S)[rank], k, "cpu")
    stream = torch.cat([stream, stream.new_full(
        (pad_to - stream.numel(),), SENTINEL)])
    out = {"count": [], "build": [], "assemble": {}}
    for cap in bucket_caps:
        ledger = ExchangeLedger()
        res = sharded_count(stream, min_cov, cap, local_cap, ledger=ledger)
        ledger.invoke("dist_count")
        out["count"].append(dict(
            table=res["table"].numpy(), counts=res["counts"].numpy(),
            n_unique=int(res["n_unique"]), overflow=res["overflow"],
            ledger=ledger.summary()["dist_count"]))
    table = torch.from_numpy(out["count"][0]["table"])
    for cap in query_caps:
        ledger = ExchangeLedger()
        succ, okv, ovf = sharded_build(table, out["count"][0]["n_unique"], k,
                                       local_cap, cap, ledger=ledger)
        ledger.invoke("dist_build")
        out["build"].append(dict(succ=succ.numpy(), okv=okv.numpy(),
                                 overflow=ovf,
                                 ledger=ledger.summary()["dist_build"]))
    for name, job_reads, params, kwargs in jobs:
        metrics = Metrics(quiet=True)
        kwargs = dict(kwargs)
        overrides = kwargs.pop("overrides", {})
        saved = {n: getattr(dsimplify, n) for n in overrides}
        try:
            for n, v in overrides.items():
                setattr(dsimplify, n, v)
            contigs = assemble_sharded(job_reads, params, metrics=metrics,
                                       device="cpu", **kwargs)
        except ValueError as e:  # a job that must be refused
            contigs = f"ValueError: {e}"
        finally:
            for n, v in saved.items():
                setattr(dsimplify, n, v)
        out["assemble"][name] = dict(contigs=contigs, events=metrics.events)
    out["simplify"] = {name: _sharded_simplify(g[rank], params)
                       for name, (g, params) in simplify["graphs"].items()}
    if simplify.get("ops_seed") is not None:
        out["ops"] = _ops(simplify["ops_seed"])
    return out


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()


def sleep(seconds):
    import time
    time.sleep(seconds)


# ---- the sharded final state and emission (tests/test_torch_dist_final.py)

_FINAL_FAST = dsimplify.make_sharded_final_fast


def starved_final_fast(group, local_capacity, slack=1.35, ledger=None):
    """make_sharded_final_fast override: slack / 1000 on its ladder's
    first rung (64-slot route buckets, _cap_for's floor: they overflow),
    JAX's slack after it."""
    return _FINAL_FAST(group, local_capacity,
                       slack / 1000 if slack < 1.4 else slack, ledger)


def tiny_emit_caps(cl2, S):
    """_emit_caps override: 8 slots for every emission buffer, too few
    on every try of the ladder."""
    return 8, 8, 8


def replicated_unreachable(*args, **kwargs):
    raise AssertionError("the replicated final state or emission ran")


@contextlib.contextmanager
def _overridden(overrides):
    """Set module attributes {"module:name": value}; restore them after."""
    saved = []
    try:
        for key, value in overrides.items():
            mod, name = key.split(":")
            m = importlib.import_module(mod)
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, value)
        yield
    finally:
        for m, name, value in reversed(saved):
            setattr(m, name, value)


def _final_case(part, k):
    """The fast and exact final state, the emission program and the
    emission (whole and in local slices) on this rank's part (succ, okv,
    counts, n_unique, alive) of one graph."""
    S = dist.get_world_size()
    succ, okv, counts, n_unique, alive = part
    succ, okv, counts, alive = (torch.from_numpy(x)
                                for x in (succ, okv, counts, alive))
    cl = counts.shape[0]
    ledger = ExchangeLedger()
    fast = dsimplify.make_sharded_final_fast(None, cl, ledger=ledger)
    *f, rnds = fast(succ, okv, counts, alive, n_unique)
    ledger.invoke("dist_final_fast")
    e = dsimplify.make_sharded_final(None, cl, ledger=ledger)(
        succ, okv, counts, alive, n_unique)
    ledger.invoke("dist_final_exact")
    caps = demit._emit_caps(2 * cl, S)
    em = demit.make_sharded_emit(None, cl, *caps, ledger)(*e[:4], okv)
    ledger.invoke("dist_emit")
    contigs, ok = demit.emit_contigs_sharded(*e[:4], okv, k)
    n = len(contigs)
    slices = {P: [demit.emit_contigs_sharded(
        *e[:4], okv, k, local_slice=(pid, P)) for pid in range(P)]
        for P in sorted({1, 2, 3, n, n + 2})}
    return dict(fast=[x.numpy() for x in f], rounds=rnds,
                exact=[x.numpy() for x in e], emit=[x.numpy() for x in em],
                emit_caps=caps, contigs=contigs, ok=ok, slices=slices,
                ledger=ledger.summary())


def final_parity(graphs, k, jobs, fasta_dir):
    """This rank's part of the final-state and emission checks: for each
    graph {name: one (succ, okv, counts, n_unique, alive) a rank}
    _final_case; assemble_sharded on each job (name, reads, params,
    overrides {"module:name": value}) with its contigs and events; and
    write_fasta_parallel into fasta_dir (one rank: the golden oracle's
    list as given, plain and .gz; two ranks: each rank's local slice of
    the graph "frag"'s emission)."""
    S, rank = dist.get_world_size(), dist.get_rank()
    out = {"graphs": {name: _final_case(parts[rank], k)
                      for name, parts in graphs.items()},
           "assemble": {}}
    for name, job_reads, params, overrides in jobs:
        metrics = Metrics(quiet=True)
        with _overridden(overrides):
            contigs = assemble_sharded(job_reads, params, metrics=metrics,
                                       device="cpu")
        out["assemble"][name] = dict(contigs=contigs, events=metrics.events)
    if S == 1:
        contigs = out["assemble"]["errors"]["contigs"]
        out["fasta"] = [demit.write_fasta_parallel(
            f"{fasta_dir}/one{ext}", contigs) for ext in (".fasta",
                                                          ".fasta.gz")]
    elif S == 2:
        mine = out["graphs"]["frag"]["slices"][2][rank][0]
        out["fasta"] = [demit.write_fasta_parallel(f"{fasta_dir}/two.fasta",
                                                   mine)]
    return out
