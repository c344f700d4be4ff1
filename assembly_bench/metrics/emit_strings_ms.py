"""emit_strings_ms: the mean host wall a job of the `emit.strings` span
(graph/contigs.py: decoding the bases and building the contig strings on
the host)."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("emit.strings",))
