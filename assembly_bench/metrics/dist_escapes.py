"""dist_escapes: rank 0's mean fallbacks a job, the `escapes` counter:
a used-up slack ladder of the sharded passes or of the sharded final
state (the graph gathered and simplified on every rank), or an emission
that overflowed every try (emitted from the gathered final state)."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "escapes")
