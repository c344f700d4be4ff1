"""bases_per_s: the input bases of every job of the window over the
whole window, from the first job's start to the last job's return."""


def read(rec):
    if not rec["jobs"] or rec["window_s"] <= 0:
        return None
    return sum(j["bases"] for j in rec["jobs"]) / rec["window_s"]
