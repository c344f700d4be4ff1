"""Entry `multihost`: the multi-process path that users with more reads
than one card holds run, `python -m genome_tpu_torch.dist.launch`: one
rank a card, each rank passing its own contiguous shard of the reads to
`assemble_multihost(local_reads, params, metrics=Metrics(quiet=True))`
with the defaults users get (the replicated escape allowed). A job ends
when rank 0 returns the contigs on the host.

The harness process is rank 0, on its own device (cuda:0). The first
`prepare` starts cfg["ranks"] - 1 worker ranks, this file run as a
script in a process each (on cuda:1, cuda:2, ... or on the CPU), which
join one group with it (NCCL on the cards, gloo on the CPU, a file
rendezvous in `workdir`, a GROUP_TIMEOUT_S timeout) and stay up for the
run. So the peak bytes, the kernel launch counters, the profiler and the
Metrics events the harness reads are rank 0's. `prepare` splits the
isolate as dist.assemble.shard_reads does and writes each worker's shard
to `workdir` as .npy (the worker loads it once, at the isolate's warm-up
job); `run` tells every worker which isolate to assemble, one line on
its standard input, then runs rank 0's part. A worker that raises exits;
rank 0's collective then fails (gloo at once, NCCL when the group's
timeout passes). `cleanup` of the last state stops the workers and
leaves the group, so that the card is the reference's alone. Each rank
prints its peak device bytes over the window to stderr once, when it
stops.

On a program whose assemble_multihost takes no `metrics` the first
`prepare` raises before any process starts.
"""

from __future__ import annotations

import atexit
import inspect
import json
import os
import subprocess
import sys
import uuid
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
GROUP_TIMEOUT_S = 300.0
_STOP_WAIT_S = 60.0

# the run's group: rank 0's side
_GROUP: dict = {}


def _params(cfg: dict):
    from genome_tpu_torch.params import AssemblyParams
    return AssemblyParams(k=cfg["k"], min_coverage=cfg["min_coverage"],
                          tip_len=cfg["tip_len"],
                          bubble_len=cfg["bubble_len"],
                          max_rounds=cfg["max_rounds"])


def _shard_path(workdir: str, name: str, rank: int) -> str:
    return os.path.join(workdir, f"{name}.rank{rank}.npy")


def _rank_device(device: str, rank: int) -> str:
    return f"cuda:{rank}" if device == "cuda" else device


def _peak_line(rank: int, dev) -> str:
    import torch
    peak = torch.cuda.max_memory_allocated(dev) \
        if torch.device(dev).type == "cuda" else 0
    return (f"[multihost] rank {rank} {dev} max_memory_allocated={peak} "
            f"({peak / 2**30:.4f} GiB)")


def _start(world: int, cfg: dict, workdir: str, device: str) -> None:
    from genome_tpu_torch.dist.mesh import init_group
    init = "file://" + os.path.join(workdir,
                                    f"rendezvous-{uuid.uuid4().hex}")
    import genome_tpu_torch
    env = dict(os.environ)
    # the checkout's root and the program rank 0 runs
    paths = [str(ROOT), str(Path(genome_tpu_torch.__file__).parents[1])]
    env["PYTHONPATH"] = os.pathsep.join(
        paths + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    if device == "cpu":  # every rank on this host's cores
        env["OMP_NUM_THREADS"] = "1"
    workers = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(r), str(world), init,
         _rank_device(device, r), workdir, json.dumps(cfg)],
        stdin=subprocess.PIPE, env=env, cwd=ROOT, text=True)
        for r in range(1, world)]
    _GROUP.update(workers=workers, states=0)
    atexit.register(_kill_workers)
    _GROUP["dev"] = init_group(0, world, init, _rank_device(device, 0),
                               timeout_s=GROUP_TIMEOUT_S)


def _kill_workers() -> None:
    for p in _GROUP.get("workers", []):
        if p.poll() is None:
            p.kill()
        p.wait()


def _tell(line: str) -> None:
    """One command line to every worker; raises when one has exited."""
    for r, p in enumerate(_GROUP["workers"], 1):
        if p.poll() is not None:
            raise RuntimeError(f"worker rank {r} exited with {p.returncode}")
        try:
            p.stdin.write(line + "\n")
            p.stdin.flush()
        except (BrokenPipeError, OSError) as e:
            raise RuntimeError(f"worker rank {r} is gone: {e}") from e


def prepare(codes, cfg: dict, workdir: str, device: str, name: str) -> dict:
    from genome_tpu_torch.dist.assemble import shard_reads
    from genome_tpu_torch.dist.multihost import assemble_multihost
    if "metrics" not in inspect.signature(assemble_multihost).parameters:
        raise RuntimeError("assemble_multihost takes no metrics=: the "
                           "program cannot run this entry")
    world = int(cfg["ranks"])
    shards = shard_reads(codes, world)
    for r in range(1, world):
        np.save(_shard_path(workdir, name, r), shards[r])
    if not _GROUP:
        _start(world, cfg, workdir, device)
    _GROUP["states"] += 1
    return dict(name=name, local=shards[0], params=_params(cfg))


def run(state: dict, job: int):
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.dist.multihost import assemble_multihost
    _tell(f"{state['name']} {job}")
    m = Metrics(quiet=True)
    contigs = assemble_multihost(state["local"], state["params"], metrics=m,
                                 device=_GROUP["dev"])
    return contigs, m.events


def collect(state: dict, raw) -> tuple[list[str] | None, list[dict]]:
    """(the job's contigs in output order, rank 0's metrics events)."""
    return raw


def cleanup(state: dict) -> None:
    state.clear()
    if not _GROUP:
        return
    _GROUP["states"] -= 1
    if _GROUP["states"] > 0:
        return
    import torch.distributed as dist
    print(_peak_line(0, _GROUP["dev"]), file=sys.stderr, flush=True)
    try:
        _tell("stop")
    except RuntimeError as e:
        print(f"[multihost] {e}", file=sys.stderr, flush=True)
    for p in _GROUP["workers"]:
        try:
            p.stdin.close()
        except OSError:
            pass
    dist.destroy_process_group()
    for p in _GROUP["workers"]:
        try:
            p.wait(_STOP_WAIT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    _GROUP.clear()


def _die_with_parent() -> None:
    """Linux: this process gets SIGKILL when rank 0's process ends."""
    import ctypes
    import signal
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _worker(rank: int, world: int, init: str, device: str, workdir: str,
            cfg: dict) -> int:
    _die_with_parent()
    import torch
    import torch.distributed as dist
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.dist.mesh import init_group
    from genome_tpu_torch.dist.multihost import assemble_multihost
    if device == "cpu":
        torch.set_num_threads(1)
    dev = init_group(rank, world, init, device, timeout_s=GROUP_TIMEOUT_S)
    params = _params(cfg)
    shards: dict = {}
    while True:
        line = sys.stdin.readline()
        if not line or line.strip() == "stop":
            break
        name, job = line.split()
        if int(job) == 0 and dev.type == "cuda":  # the window's first job
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            if name not in shards:
                shards[name] = np.load(_shard_path(workdir, name, rank))
            assemble_multihost(shards[name], params,
                               metrics=Metrics(quiet=True), device=dev)
        except BaseException:
            import traceback
            traceback.print_exc()
            sys.stderr.flush()
            os._exit(1)  # the group is broken: leave it without a collective
    print(_peak_line(rank, dev), file=sys.stderr, flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    # the checkout's root in place of this script's folder
    sys.path[0] = str(ROOT)
    a = sys.argv[2:]
    raise SystemExit(_worker(int(a[0]), int(a[1]), a[2], a[3], a[4],
                             json.loads(a[5])))
