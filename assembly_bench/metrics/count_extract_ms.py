"""count_extract_ms: the mean device time a job of the `count.extract`
span (pipeline.extract_stream: host packing, uploads and the extraction
kernels of every chunk), from its CUDA events."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("count.extract",), device=True)
