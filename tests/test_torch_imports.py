"""Import hygiene of the port: every module of genome_tpu_torch imports in
a fresh interpreter without pulling in JAX or anything of genome_tpu; the
golden oracles pull in no torch and none of the code they check; every
port test file runs torch on one CPU thread."""

import pkgutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import genome_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = ["genome_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(genome_tpu_torch.__path__,
                                          "genome_tpu_torch."))
_CHECK = """
import importlib, sys
importlib.import_module({mod!r})
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "genome_tpu" or m.startswith("genome_tpu."))
assert not bad, bad
"""


def _import_in_subprocess(mod):
    return subprocess.run([sys.executable, "-c", _CHECK.format(mod=mod)],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def import_results():
    """One fresh interpreter per module, a few at a time."""
    with ThreadPoolExecutor(max_workers=4) as pool:
        return dict(zip(MODULES, pool.map(_import_in_subprocess, MODULES)))


def test_every_module_is_listed():
    assert "genome_tpu_torch.assemble.pipeline" in MODULES
    assert "genome_tpu_torch.kernels.compact" in MODULES
    assert len(MODULES) >= 20


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_without_jax(import_results, mod):
    r = import_results[mod]
    assert r.returncode == 0, r.stderr


def test_golden_is_independent_of_the_checked_code():
    """genome_tpu_torch.golden imports only the port's params and
    utils.dna: no torch, no kernel, graph or assemble module."""
    check = ("import sys, genome_tpu_torch.golden\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'genome_tpu', 'genome_tpu_torch')))")
    r = subprocess.run([sys.executable, "-c", check], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert eval(r.stdout) == [
        "genome_tpu_torch", "genome_tpu_torch.golden",
        "genome_tpu_torch.golden.assembler", "genome_tpu_torch.golden.tiny",
        "genome_tpu_torch.params", "genome_tpu_torch.utils",
        "genome_tpu_torch.utils.dna"]


def test_port_test_files_run_torch_on_one_thread():
    """Every port test file but the card's lane imports tests/torch_cpu.py's
    autouse fixture, so none runs at torch's default thread count."""
    skip = {ROOT / "tests/test_torch_cuda.py", Path(__file__).resolve()}
    files = sorted(set(ROOT.glob("tests/test_torch_*.py")) - skip)
    assert len(files) >= 17
    line = "from tests.torch_cpu import one_torch_thread  # noqa: F401"
    missing = [f.name for f in files
               if line not in f.read_text().splitlines()]
    assert not missing, missing
