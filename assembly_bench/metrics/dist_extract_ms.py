"""dist_extract_ms: rank 0's mean `dist_extract` phase wall a job of
assemble_multihost: the extraction of rank 0's shard (packing, uploads,
the extraction kernels) and the agreement on the padded stream length."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "dist_extract")
