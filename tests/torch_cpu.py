"""The port's CPU thread policy for its tests: torch on one thread.

Every `tests/test_torch_*.py` that runs torch ops in its own process
imports the fixture by name, which makes it autouse for that module:

    from tests.torch_cpu import one_torch_thread  # noqa: F401

`tests/test_torch_imports.py` checks that each of them does.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one intra-op thread for the whole module, then the count
    it had.

    The port's CPU tests run thousands of tiny ops, and at torch's default
    (one thread a core) each op waits at the pool's barriers; the suite's
    parallel workers then run a pool each on the same cores. On an 8-core
    host `run_pipeline` on the planted fixture took 8.4-11.2 s a call at
    the default and 1.6-1.8 s on one thread, and
    `tests/test_torch_pipeline.py` alone took 134 s wall and 487 s of CPU
    at the default against 86 s and 145 s on one thread, about 50 s of
    that JAX compiling its reference. Module scope: autouse fixtures of a
    scope run before the others of it, so the module fixtures that run
    the port run on one thread too. A fixture cannot reach a child
    interpreter: a test that starts one sets `OMP_NUM_THREADS=1` in its
    environment (`run_local`'s ranks pin themselves)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
