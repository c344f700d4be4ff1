"""count_ms: the mean `count` phase wall a job (extraction and count)."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "count")
