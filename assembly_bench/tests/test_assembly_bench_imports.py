"""What the benchmark loads: never JAX nor the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's),
and a reference that imports nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import types

import pytest

from _assembly_bench_tiny import ROOT
from assembly_bench import harness

BENCH_DIR = ROOT / "assembly_bench"
# the yardstick's own modules: none may import the program
YARDSTICK = ("reference", "gen", "fastx", "trace", "records", "kernel_bytes")


def _tops(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "genome_tpu_torch_probe",
                        types.ModuleType("genome_tpu_torch_probe"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "genome_tpu.probe",
                        types.ModuleType("genome_tpu.probe"))
    assert "genome_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    """A whole run of a small cell, both entries, in a fresh interpreter."""
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT / 'assembly_bench' / 'tests')!r})
from _assembly_bench_tiny import bench_copy
from pathlib import Path
from assembly_bench import harness
root = bench_copy(Path({str(tmp_path)!r}))
for cell in ("tiny.pipeline", "tiny.cli"):
    res = harness.run_cell(cell, 5, 0.2, False, device="cpu", root=root,
                           log=lambda *a, **k: None)["result"]
    assert res["correct"], res
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    tops = _tops(code)
    assert "genome_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_yardstick_imports_nothing_of_the_program():
    code = ("import json, sys\n"
            + "".join(f"import assembly_bench.{m}\n" for m in YARDSTICK)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    tops = _tops(code)
    assert not tops & {"genome_tpu_torch", *harness.FORBIDDEN}


@pytest.mark.parametrize("name", YARDSTICK)
def test_yardstick_source_imports(name):
    tree = ast.parse((BENCH_DIR / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "assembly_bench", "contextlib", "json",
                    "math", "os", "pathlib", "statistics", "time", "types",
                    "numpy", "torch"}


def test_nothing_reads_the_jax_packages_records():
    names = ["bench" + ".py", "BENCH" + "_r0", "BENCH" + ".md",
             "bench_golden" + "_cache", "MULTI" + "CHIP_r0"]
    for path in BENCH_DIR.rglob("*"):
        if path.suffix in (".py", ".json") and "tests" not in path.parts:
            text = path.read_text()
            assert not [n for n in names if n in text], path
