"""dist_final_ms: rank 0's mean `dist_final_sharded` phase wall a job of
assemble_multihost: the sharded final state (the ruler-ranking fast
final, the exact one on its fallback)."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "dist_final_sharded")
