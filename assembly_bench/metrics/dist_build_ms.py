"""dist_build_ms: rank 0's mean `dist_build` phase wall a job of
assemble_multihost: the sharded graph build (the boundary probes and
their replies, two all_to_alls)."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "dist_build")
