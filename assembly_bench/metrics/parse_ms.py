"""parse_ms: the mean `read_input` phase wall a job (the CLI's parser,
io/native), from the --metrics JSONL."""

from assembly_bench.records import phase_ms


def read(rec):
    return phase_ms(rec, "read_input")
