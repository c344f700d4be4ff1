"""setup_s: process start to the first timed job (host clock)."""


def read(rec):
    return rec["setup_s"]
