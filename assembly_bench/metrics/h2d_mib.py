"""h2d_mib: the mean host-to-device bytes a job in MiB, the `h2d_bytes`
counter of its phases (the packed codes, and the mask where uploaded)."""

from assembly_bench.program_events import counter_mean


def read(rec):
    return counter_mean(rec, "h2d_bytes", scale=2.0**-20)
