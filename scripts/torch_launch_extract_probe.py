"""Why does the launcher's extract phase take longer than in process?

chip_smoke.py's `[dist multihost launch]` record (a fresh process: the
legacy reads parsed from FASTQ by the launcher's _load_local_shard) shows
its `extract` phase at about 2.6x the in-process `[dist multihost]`
run's (the bench workload's code matrix, in the smoke's long-lived
process). This probe separates the matrix from the process: in one fresh
process on the card it holds both matrices (M: the FASTQ parsed as the
launcher parses it; E: bench_workload(1.0)["err"]) and, in turns (M, E,
E, M, ...):

  1. extract_stream alone (host clock between two device syncs), and
     pack_codes_host over the same 2^18-row chunks alone (host only);
  2. assemble_multihost on a NCCL group of one rank, its phase_times
     extract and wall.

It prints each matrix's shape, strides and flags, then one line a call.

    PYTHONPATH=. python3 scripts/torch_launch_extract_probe.py [--reps 4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


def _sync_wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist
    from genome_tpu_torch.assemble.pipeline import extract_stream
    from genome_tpu_torch.dist.launch import _load_local_shard
    from genome_tpu_torch.dist.multihost import assemble_multihost, initialize
    from genome_tpu_torch.io.benchdata import bench_workload, codes_to_reads
    from genome_tpu_torch.kernels.extract import pack_codes_host
    from genome_tpu_torch.params import AssemblyParams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    params = AssemblyParams(k=21, min_coverage=2)
    w = bench_workload(1.0)
    with tempfile.TemporaryDirectory() as td:
        fq = os.path.join(td, "reads.fastq")
        reads = codes_to_reads(w["err"], w["num_reads"])
        with open(fq, "w") as f:
            for i in range(0, len(reads), 1 << 16):
                f.write("".join(f"@r{j}\n{r}\n+\n{'I' * len(r)}\n"
                                for j, r in enumerate(
                                    reads[i : i + (1 << 16)], i)))
        del reads
        t0 = time.perf_counter()
        m = _load_local_shard([fq], 0, 1)
        print(f"[probe] parse {time.perf_counter() - t0:.4f} s | {smi}",
              flush=True)
    mats = {"M": m, "E": w["err"]}
    for name, a in mats.items():
        print(f"[probe] {name} shape={a.shape} strides={a.strides} "
              f"C={a.flags['C_CONTIGUOUS']} owndata={a.flags['OWNDATA']} "
              f"base={type(a.base).__name__} max_code={int(a.max())}",
              flush=True)
    order = [n for _ in range(args.reps) for n in ("M", "E", "E", "M")]
    for name in order:
        a = mats[name]
        t, s = _sync_wall(lambda: extract_stream(a, params.k, "cuda"))
        t0 = time.perf_counter()
        for i in range(0, a.shape[0], 1 << 18):
            pack_codes_host(a[i : i + (1 << 18)], pin_memory=True)
        pack = time.perf_counter() - t0
        print(f"[probe] {name} extract_stream {t:.4f} s ({s.numel()} "
              f"windows); pack_codes_host alone {pack:.4f} s", flush=True)
        del s
    with tempfile.TemporaryDirectory() as td:
        initialize(f"file://{td}/rendezvous", 1, 0, device="cuda")
        try:
            for name in order:
                pt = {}
                t, _ = _sync_wall(lambda: assemble_multihost(
                    mats[name], params, phase_times=pt))
                print(f"[probe] {name} assemble_multihost wall {t:.4f} s "
                      f"extract {pt['extract']:.4f} s count "
                      f"{pt['count']:.4f} s", flush=True)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
