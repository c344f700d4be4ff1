"""exchange_calls: rank 0's mean collective calls a job, the
`collectives` counter: every all_to_all and all_gather, and every
agreement (all_max, all_any_each), each a barrier between the ranks."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "collectives")
