"""simplify_rounds: the mean number of `simplify_round` events a job."""

import statistics


def read(rec):
    jobs = [j for j in rec["jobs"]
            if any(e.get("phase") == "simplify" for e in j["events"])]
    if not jobs:
        return None
    return statistics.fmean(
        sum(e.get("event") == "simplify_round" for e in j["events"])
        for j in jobs)
