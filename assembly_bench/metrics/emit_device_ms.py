"""emit_device_ms: the mean host wall a job of the `emit.device` span
(graph/contigs.py::emit_contigs_device: the device ordering and the
contig-start compaction, up to the host read of their counts)."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("emit.device",))
