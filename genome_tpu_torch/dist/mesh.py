"""The shard axis as a torch.distributed process group (the counterpart of
the JAX package's mesh axis and of dist/assemble.py::_default_mesh).

One process per rank; the rank is the shard. NCCL for a CUDA device (one
rank a card), gloo for the CPU. Every function here is a collective:
every rank of the group calls it, in the same order. Host decisions that
JAX took from a gathered array (an overflow retry, a table size) go
through all_max / all_any, so that every rank takes the same branch.

Each collective is counted in the current phase (assemble/metrics.py):
`collectives` counts every call, the agreements included; an exchange
of rows (all_to_all_rows, all_gather_rows) is also a device span
`dist.exchange`, whose device time includes the wait for the slowest
rank, and adds the bytes that leave this rank, (S - 1)/S of its output
buffer, to `exchange_bytes`; the agreements' host reads go through
host_read, so `syncs` counts them.

run_local starts a whole group of ranks on this host, the counterpart of
the JAX package's fake cluster (multihost.py, tests/conftest.py).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from genome_tpu_torch.assemble.metrics import count, host_read, span
from genome_tpu_torch.utils.device import resolve_device


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def shard_device(device="cuda", rank: int = 0) -> torch.device:
    """The rank's device: "cuda" means cuda:{LOCAL_RANK}, or cuda:{rank %
    device_count} without a launcher. Raises when there is no card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        idx = int(local) if local else rank % torch.cuda.device_count()
        dev = torch.device("cuda", idx)
    return dev


def init_group(rank: int, world: int, init_method: str, device="cuda",
               backend: str | None = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join the default process group as `rank` of `world`; returns the
    rank's device. The backend follows the device (NCCL for CUDA, gloo for
    the CPU); asking for the other one raises."""
    dev = shard_device(device, rank)
    want = _backend_for(dev)
    if backend is not None and backend != want:
        raise ValueError(f"backend {backend!r} does not serve device {dev} "
                         f"(use {want!r})")
    kwargs = {}
    if want == "nccl":
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(
        want, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dev


def group_device(group=None) -> torch.device:
    """The device the group's collectives take their tensors on."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_device(dev: torch.device, group=None) -> None:
    backend = dist.get_backend(group)
    if backend != _backend_for(dev):
        raise ValueError(f"device {dev} does not match the {backend} group "
                         f"(NCCL takes CUDA tensors, gloo CPU tensors)")


def all_to_all_rows(buf: torch.Tensor, group=None) -> torch.Tensor:
    """[S, w] -> [S, w]: row j goes to rank j, and row i of the result is
    what rank i sent (JAX all_to_all(split_axis=0, concat_axis=0,
    tiled=True) over the mesh axis)."""
    if buf.shape[0] != dist.get_world_size(group):
        raise ValueError(f"{buf.shape[0]} rows for a group of "
                         f"{dist.get_world_size(group)}")
    buf = buf.contiguous()
    out = torch.empty_like(buf)
    with _exchange(out.numel() * out.element_size(), out.device, group):
        dist.all_to_all_single(out, buf, group=group)
    return out


def _exchange(out_bytes: int, device: torch.device, group):
    """The span and counters of one exchange into an output buffer of
    `out_bytes` bytes."""
    S = dist.get_world_size(group)
    count("collectives")
    count("exchange_bytes", out_bytes * (S - 1) // S)
    return span("dist.exchange", device=device)


def all_max(x: int, group=None) -> int:
    """The largest of every rank's host integer."""
    t = torch.tensor([int(x)], dtype=torch.int64, device=group_device(group))
    count("collectives")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return host_read("dist.all_max", lambda: int(t.item()))


def all_any(flag, group=None) -> bool:
    """True on every rank when any rank's flag is set."""
    return all_max(int(bool(flag)), group) > 0


def all_any_each(flags, group=None) -> list[bool]:
    """all_any of each of several flags (bools or 0-dim tensors on the
    rank's device), in one all_reduce."""
    dev = group_device(group)
    t = torch.stack([torch.as_tensor(f, device=dev).reshape(())
                     .to(torch.int64) for f in flags])
    count("collectives")
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [v > 0 for v in host_read("dist.all_any_each", t.tolist)]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x (equal shapes), concatenated along dim 0 in rank
    order."""
    x = x.contiguous()
    S = dist.get_world_size(group)
    parts = [torch.empty_like(x) for _ in range(S)]
    with _exchange(S * x.numel() * x.element_size(), x.device, group):
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


_LOCAL_GROUP_TIMEOUT_S = 60.0  # run_local's collectives give up after this


def _rank_entry(rank, fn, world, device, init_method, out_dir, args):
    torch.set_num_threads(1)  # a host runs every rank: no oversubscription
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:  # not an inherited LOCAL_RANK
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    init_group(rank, world, init_method, dev,
               timeout_s=_LOCAL_GROUP_TIMEOUT_S)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


def run_local(fn, world: int, device="cuda", timeout_s: float = 120.0,
              args: tuple = ()) -> list:
    """Run fn(*args) on `world` ranks of a new group on this host and return
    each rank's (picklable) result, in rank order.

    device="cuda" puts rank r on cuda:{r % device_count} in a NCCL group
    (and raises without a card); device="cpu" makes a gloo group.

    The ranks are spawned processes that meet through a file in a new
    temporary directory (no port to collide on). fn must be importable by
    name in a fresh interpreter. A rank that raises makes run_local raise
    (the others are killed); past `timeout_s` every rank is killed and
    run_local raises TimeoutError. Each collective gives up after 60 s."""
    resolve_device(device)  # no card: raise here, before any spawn
    with tempfile.TemporaryDirectory(prefix="genome_tpu_torch_dist_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(
            _rank_entry, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, device, init_method, tmp, tuple(args)))
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"run_local: {fn.__qualname__} on {world} ranks "
                        f"still running after {timeout_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
