"""job_p90_s: the 90th percentile of the job walls of the window (host
clock, from the call into the entry to its return)."""

import statistics


def read(rec):
    walls = [j["wall_s"] for j in rec["jobs"]]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
