"""simplify_ms: the mean `simplify` phase wall a job."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "simplify")
