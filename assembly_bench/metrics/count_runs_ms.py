"""count_runs_ms: the mean device time a job of the `count.runs` spans
(kernels/count.py::count_kmers_device: run heads, run counts and the
coverage filter, two compactions), from their CUDA events."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("count.runs",), device=True)
