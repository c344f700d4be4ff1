"""Per-rank bodies for tests/test_torch_dist.py, run by
genome_tpu_torch.dist.run_local in spawned processes. This module imports
only the port (no JAX), so a rank starts quickly and never touches JAX."""

import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.assemble.pipeline import extract_stream
from genome_tpu_torch.dist import assemble_sharded, shard_reads
from genome_tpu_torch.dist.build import sharded_build
from genome_tpu_torch.dist.count import sharded_count
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.kernels.keys import SENTINEL


def parity(reads, k, min_cov, pad_to, bucket_caps, local_cap, query_caps,
           jobs):
    """This rank's count at each bucket cap (its window stream padded to
    pad_to), its build at each query cap (from the first count's table),
    and assemble_sharded on each job (name, reads, params, kwargs)."""
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
        try:
            contigs = assemble_sharded(job_reads, params, metrics=metrics,
                                       device="cpu", **kwargs)
        except ValueError as e:  # a job that must be refused
            contigs = f"ValueError: {e}"
        out["assemble"][name] = dict(contigs=contigs, events=metrics.events)
    return out


def fail_on_rank_1():
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()


def sleep(seconds):
    import time
    time.sleep(seconds)
