"""dist_emit_ms: rank 0's mean `dist_contigs` phase wall a job of
assemble_multihost: the emission (the sharded one, or its gathered
fallback), to the sorted contigs on the host."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "dist_contigs")
