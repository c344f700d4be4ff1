#!/usr/bin/env python3
"""Readings for the limits of `correct`, at a cell's own size, in one
process (the benchmark's own runs do not run this).

    python3 assembly_bench/control.py --workload <cell> \
        --control-seeds 1,2,3 --program-seeds 4,5,...,15 [--seconds 3]

For each program seed, a run of the cell as run.py makes it (set-up, a
short window at the cell's load, every job compared with the reference)
gives the program's reading of `jobs_wrong`: the lower reading. For each
control seed, the same run with the control in the program's place (the
reference with one stated guarantee broken: a bubble keeps its side by
the smaller head k-mer alone, not by the higher k-mer count sum) gives
the control's reading, which has to come out as not correct. One line a
run: `[reading] <who> seed=<n> jobs=<n> jobs_wrong=<n> correct=<bool>`.
"""

from __future__ import annotations

import argparse
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root in place of this script's folder, whose module
# names (trace, gen) must not shadow others
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_entry(entry):
    """The entry with the control reference in the program's place."""
    from assembly_bench import reference

    def prepare(codes, cfg, workdir, device, name):
        return dict(codes=codes, cfg=cfg, device=device)

    def run(state, job):
        c = state["cfg"]
        return reference.assemble(state["codes"], c["k"], c["min_coverage"],
                                  c["tip_len"], c["bubble_len"],
                                  c["max_rounds"], device=state["device"],
                                  control=True)

    return types.SimpleNamespace(prepare=prepare, run=run,
                                 collect=lambda state, raw: (raw, []),
                                 cleanup=lambda state: None)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--program-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from assembly_bench import harness
    quiet = lambda *a, **k: None  # noqa: E731
    runs = [("program", s, None) for s in _seeds(args.program_seeds)] + \
        [("control", s, control_entry) for s in _seeds(args.control_seeds)]
    worst = {"program": 0, "control": None}
    for who, seed, wrap in runs:
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               device=args.device, root=ROOT, log=quiet,
                               wrap_entry=wrap)
        res, c = out["result"], out["checks"]
        wrong = c["jobs_wrong"]["value"] + c["jobs_failed"]["value"]
        print(f"[reading] {who} seed={seed} jobs={res['attempted']} "
              f"jobs_wrong={wrong} correct={res['correct']} "
              f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
        if who == "program":
            worst["program"] = max(worst["program"], wrong)
        else:
            worst["control"] = wrong if worst["control"] is None \
                else min(worst["control"], wrong)
    print(f"[readings] program (lower) max jobs_wrong={worst['program']}; "
          f"control (upper) min jobs_wrong={worst['control']}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
