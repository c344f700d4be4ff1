"""build_ms: the mean `build` phase wall a job (graph/build.py)."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "build")
