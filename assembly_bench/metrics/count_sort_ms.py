"""count_sort_ms: the mean device time a job of the `count.sort` spans
(kernels/count.py::count_kmers_device: the sort of the window stream),
from their CUDA events; a capacity retry adds its own."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("count.sort",), device=True)
