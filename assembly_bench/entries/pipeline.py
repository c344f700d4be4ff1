"""Entry `pipeline`: the library call a Python user makes on an isolate's
code matrix, `run_pipeline(codes, params, metrics=Metrics(quiet=True))`
with the defaults users get (automatic capacity, the sort counter). A
job ends when it returns the contigs on the host."""

from __future__ import annotations


def prepare(codes, cfg: dict, workdir: str, device: str, name: str) -> dict:
    from genome_tpu_torch.params import AssemblyParams
    params = AssemblyParams(k=cfg["k"], min_coverage=cfg["min_coverage"],
                            tip_len=cfg["tip_len"],
                            bubble_len=cfg["bubble_len"],
                            max_rounds=cfg["max_rounds"])
    return dict(codes=codes, params=params, device=device)


def run(state: dict, job: int):
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.assemble.pipeline import run_pipeline
    m = Metrics(quiet=True)
    res = run_pipeline(state["codes"], state["params"], metrics=m,
                       device=state["device"])
    return res["contigs"], m.events


def collect(state: dict, raw) -> tuple[list[str] | None, list[dict]]:
    """(the job's contigs in output order, its metrics events)."""
    return raw


def cleanup(state: dict) -> None:
    state.clear()
