"""exchange_ms: rank 0's mean device time a job of the `dist.exchange`
spans (every all_to_all and all_gather of the sharded path, dist/mesh.py),
from their CUDA events: the exchanges' time plus the wait for the slowest
rank at each of them."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("dist.exchange",), device=True)
