"""dist_emit_device_ms: rank 0's mean host wall a job of the
`dist_emit.device` span (dist/emit.py::contigs_from_gathered: after the
all_gather, the gathered blocks ordered, joined to their head k-mers and
written as canonical ASCII bytes on the card, with the one host read of
the counts)."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("dist_emit.device",))
