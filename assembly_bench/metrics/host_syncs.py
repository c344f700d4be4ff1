"""host_syncs: the mean host reads of device data a job, the `syncs`
counter summed over every phase."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "syncs")
