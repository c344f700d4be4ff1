"""dist_simplify_ms: rank 0's mean wall a job of assemble_multihost's
simplify phases: `dist_simplify_sharded` (the sharded tip and bubble
passes with their slack ladder) plus, where a used-up ladder took the
escape, `dist_simplify` (the gathered graph simplified on every rank)."""

import statistics

PHASES = ("dist_simplify_sharded", "dist_simplify")


def read(rec):
    out = []
    for job in rec["jobs"]:
        walls = [e["wall_s"] for e in job["events"]
                 if e.get("event") == "phase_end"
                 and e.get("phase") in PHASES]
        if walls:
            out.append(sum(walls))
    return 1e3 * statistics.fmean(out) if out else None
