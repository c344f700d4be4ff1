"""parse_scan_ms: the mean host wall a job of the native parser's two
single-threaded passes over the file, the `parse.scan` and `parse.index`
spans (io/native/cio.py::parse_fastx_codes: record count and longest
record, then the record offsets), before the threaded decode."""

from assembly_bench.program_events import span_ms


def read(rec):
    return span_ms(rec, ("parse.scan", "parse.index"))
