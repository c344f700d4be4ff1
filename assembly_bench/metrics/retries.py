"""retries: the mean pieces of work redone a job, the `retries` counter
summed over every phase (count capacity doublings, overflowed walk
rungs and degree updates, dense fallbacks, the final state's dense
path and tail overflow, the emission's contig-buffer redo)."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "retries")
