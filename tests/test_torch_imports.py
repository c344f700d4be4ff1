"""Import hygiene of the port: every module of genome_tpu_torch imports in
a fresh interpreter without pulling in JAX or anything of genome_tpu."""

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
