"""dist_emit_strings_ms: rank 0's mean host wall a job of the
`dist_emit.strings` span (dist/emit.py::contigs_from_gathered: decoding
the copied bytes, slicing the contigs and sorting them on the host)."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("dist_emit.strings",))
