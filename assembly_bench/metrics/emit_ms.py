"""emit_ms: the mean `emit_s` of the `contigs` phase a job (emission)."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "contigs", "emit_s")
