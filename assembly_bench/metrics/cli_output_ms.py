"""cli_output_ms: the mean of a CLI job's wall less its logged phases
(read_input, count, build, simplify, contigs): writing the FASTA, the
assembly stats and the CLI's own overhead."""

import statistics

from assembly_bench.records import PHASES


def read(rec):
    out = []
    for j in rec["jobs"]:
        ends = [e for e in j["events"] if e.get("event") == "phase_end"
                and e.get("phase") in PHASES]
        if any(e["phase"] == "read_input" for e in ends):
            out.append(j["wall_s"] - sum(e["wall_s"] for e in ends))
    return 1e3 * statistics.fmean(out) if out else None
