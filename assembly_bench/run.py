#!/usr/bin/env python3
"""The benchmark's command: one run of one cell on one CUDA card.

    python3 assembly_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration, its entry
and its metrics are found by name (harness.py). Without a CUDA card, or
with fewer cards than the cell asks for, it exits with 3 and prints no
result; it never falls back to the CPU. The last line of standard output
is the result's JSON object; the numbers compared for `correct` are the
last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the program's build caches stay at fixed paths inside the checkout (the
# port's own kernels build into genome_tpu_torch/_build/)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
# the checkout's root in place of this script's folder, whose module
# names (trace, gen) must not shadow others
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,clocks.mem", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from assembly_bench import harness
    chips = harness.workload(harness.benchmark(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 3
    print(f"[card] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvidia-smi name, power.limit, "
          f"clocks.sm, clocks.max.sm, clocks.mem: {_smi()}", file=sys.stderr)

    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device="cuda", root=ROOT,
                           t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"[check] {name}={c['value']} limit={c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
