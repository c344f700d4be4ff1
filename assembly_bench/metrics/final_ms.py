"""final_ms: the mean `final_s` of the `contigs` phase a job (the final
chain state)."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "contigs", "final_s")
