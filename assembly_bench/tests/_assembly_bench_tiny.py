"""Shared set-up of the benchmark's CPU tests: a copy of the benchmark
with small cells of its own, which the harness finds by name."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a 20 kbp genome: the pipeline takes about a second a job on the CPU
TINY = dict(genome_len=20000, repeat_families=[[1000, 3], [300, 5]])
TINY_CONFIGS = {"tiny": {}}
TINY_CELLS = {
    "tiny.pipeline": dict(entry="pipeline", coverage=24, ploidy=2,
                          het_rate=0.002, isolates=2),
    "tiny.cli": dict(entry="cli", coverage=24, ploidy=1, isolates=2),
}


def bench_copy(dst: Path, cells=TINY_CELLS, configs=TINY_CONFIGS) -> Path:
    """A checkout-like root in `dst`: BENCHMARK.json and assembly_bench/,
    plus `configs` (each ecoli_k21 at 20 kbp with its own keys updated)
    and `cells` (each named <config>.<traffic>), all added as data files
    and BENCHMARK.json entries only."""
    shutil.copytree(ROOT / "assembly_bench", dst / "assembly_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    base = json.loads(
        (ROOT / "assembly_bench/configs/ecoli_k21.json").read_text())
    for name, keys in configs.items():
        cfg = {**base, "name": name, **TINY, **keys}
        (dst / f"assembly_bench/configs/{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append(dict(
            name=name, source=cfg["source"],
            file=f"assembly_bench/configs/{name}.json",
            reduced=cfg["reduced"], why="a CPU test"))
    for name, cell in cells.items():
        config, traffic = name.split(".", 1)
        (dst / f"assembly_bench/cells/{name}.json").write_text(json.dumps(
            dict(config=config, traffic=traffic, **cell)))
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=traffic, chips=1,
                                       why="a CPU test"))
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m and (m["name"] not in ("parse_ms",
                                                       "cli_output_ms")
                                     or cell["entry"] == "cli"):
                m["workloads"].append(name)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dst
