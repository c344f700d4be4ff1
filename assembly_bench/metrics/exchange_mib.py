"""exchange_mib: rank 0's mean bytes a job that leave it in the sharded
path's exchanges, the `exchange_bytes` counter ((S - 1)/S of each
all_to_all or all_gather output buffer), in MiB."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "exchange_bytes", scale=1 / 2**20)
