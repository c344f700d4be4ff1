"""simplify_wait_ms: the mean host time a job spent blocked in the
`simplify` phase's host reads (its `sync_wait_s` counter), in ms."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "sync_wait_s", phase="simplify", scale=1e3)
