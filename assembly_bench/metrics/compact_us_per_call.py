"""compact_us_per_call: the device time of the compaction kernel
(`compact_tiles`, kernels/csrc/compact.cu) and of the memset launched just
before it on its stream, over the window's compaction launches (the sum of
kernels.compact.LAUNCHES), in us."""


def read(rec):
    tr, calls = rec.get("trace"), rec["launches"].get("compact", 0)
    if not tr or not calls:
        return None
    last: dict = {}
    us = 0.0
    for e in tr["rows"]:
        stream = e.get("args", {}).get("stream")
        if e["cat"] == "kernel" and e["name"].startswith("compact_tiles"):
            us += e["dur"]
            prev = last.get(stream)
            if prev is not None and prev["cat"] == "gpu_memset":
                us += prev["dur"]
        last[stream] = e
    return us / calls if us else None
