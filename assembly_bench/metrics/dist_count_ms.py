"""dist_count_ms: rank 0's mean `dist_count` phase wall a job of
assemble_multihost: the sharded count (the route of every window to its
owner, one all_to_all, and the owner's sort and run pass), with its
capacity retries."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "dist_count")
