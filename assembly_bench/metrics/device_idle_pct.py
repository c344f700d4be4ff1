"""device_idle_pct: 100 x (1 - device-busy time / window wall) in the
traced window; busy is the union of every kernel, copy and memset."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
