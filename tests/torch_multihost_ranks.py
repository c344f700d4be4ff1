"""Per-rank bodies for tests/test_torch_multihost.py, run by
genome_tpu_torch.dist.run_local in spawned processes. This module imports
only the port (no JAX), so a rank starts quickly and never touches JAX."""

import torch.distributed as dist

from genome_tpu_torch.assemble.checkpoint import (PhaseCheckpointer,
                                                  input_digest)
from genome_tpu_torch.dist import assemble_multihost, shard_reads
from genome_tpu_torch.dist import simplify as dsimplify
from genome_tpu_torch.params import AssemblyParams

from tests.torch_dist_ranks import _overridden

_SIMPLIFY = dsimplify.make_sharded_simplify
_FINAL_FAST = dsimplify.make_sharded_final_fast
_FINAL_EXACT = dsimplify.make_sharded_final


def unreachable(*args, **kwargs):
    raise AssertionError("a path this job must not take ran")


def starved_simplify_all(group, local_capacity, slack, *args):
    """make_sharded_simplify override: slack / 1000 on every rung (the
    route buckets at _cap_for's 64-slot floor overflow): the ladder is
    used up."""
    return _SIMPLIFY(group, local_capacity, slack / 1000, *args)


def starved_final_fast_all(group, local_capacity, slack=1.35, ledger=None):
    """make_sharded_final_fast override: slack / 1000 on every rung (the
    route buckets at _cap_for's 64-slot floor overflow)."""
    return _FINAL_FAST(group, local_capacity, slack / 1000, ledger)


def starved_final_exact_all(group, local_capacity, slack=1.35, ledger=None):
    """make_sharded_final override: slack / 1000 on every rung."""
    return _FINAL_EXACT(group, local_capacity, slack / 1000, ledger)


def multihost(reads, k, min_coverage, jobs, ckpt_dir, extra):
    """assemble_multihost on this rank's contiguous shard of `reads`, once
    a job: (name, kwargs, overrides {"module:name": value}); the kwargs
    may hold out_path (a path under which each job writes). Then the
    resume sequence with a PhaseCheckpointer of this rank's shard under
    ckpt_dir: a fresh run, a resumed run, and a run in which rank 0's
    shard gains two copies of the read `extra` (its input digest no
    longer matches, so no rank may resume). Returns, per job, the
    contigs (or the count written, or "RuntimeError: ...") and the
    phase_times keys, with the fast final's rounds."""
    S, rank = dist.get_world_size(), dist.get_rank()
    params = AssemblyParams(k=k, min_coverage=min_coverage)
    local = shard_reads(reads, S)[rank]
    out = {}

    def run(name, shard, **kwargs):
        pt = {}
        try:
            res = assemble_multihost(shard, params, phase_times=pt,
                                     device="cpu", **kwargs)
        except RuntimeError as e:
            res = f"RuntimeError: {e}"
        out[name] = dict(result=res, phases=sorted(pt),
                         rounds=pt.get("exchange_ledger", {}).get(
                             "final_fast_rounds"))

    for name, kwargs, overrides in jobs:
        with _overridden(overrides):
            run(name, local, **kwargs)

    def ckpt(shard):
        return PhaseCheckpointer(ckpt_dir, params, shard=rank, num_shards=S,
                                 n_devices=S,
                                 input_digest=input_digest(shard))
    run("resume_fresh", local, ckpt=ckpt(local))
    run("resume_again", local, ckpt=ckpt(local))
    changed = local + [extra] * 2 if rank == 0 else local
    run("resume_changed", changed, ckpt=ckpt(changed))
    return out


def multihost_metrics(codes, k, jobs):
    """assemble_multihost with a Metrics on this rank's contiguous shard
    of the code matrix `codes`, once a job: (name, overrides). Every
    collective call is spied on: returns, per job, the contigs, the
    Metrics events, the calls of each collective and the bytes that
    left this rank, (S - 1)/S of each exchange's output buffer."""
    from genome_tpu_torch.assemble.metrics import Metrics
    S, rank = dist.get_world_size(), dist.get_rank()
    params = AssemblyParams(k=k, min_coverage=2)
    local = shard_reads(codes, S)[rank]
    out = {}
    for name, overrides in jobs:
        seen = dict(all_to_all_single=0, all_gather=0, all_reduce=0,
                    bytes=0)

        def spied(fn_name, out_bytes):
            fn = getattr(dist, fn_name)

            def call(*args, **kwargs):
                seen[fn_name] += 1
                seen["bytes"] += out_bytes(args) * (S - 1) // S
                return fn(*args, **kwargs)
            return call

        spies = {
            "torch.distributed:all_to_all_single": spied(
                "all_to_all_single",
                lambda a: a[0].numel() * a[0].element_size()),
            "torch.distributed:all_gather": spied(
                "all_gather",
                lambda a: sum(t.numel() * t.element_size() for t in a[0])),
            "torch.distributed:all_reduce": spied("all_reduce",
                                                  lambda a: 0)}
        m = Metrics(quiet=True)
        with _overridden({**spies, **overrides}):
            contigs = assemble_multihost(local, params, metrics=m,
                                         device="cpu")
        out[name] = dict(contigs=contigs, events=m.events, seen=seen)
    return out
