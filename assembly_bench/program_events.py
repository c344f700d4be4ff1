"""Helpers the readers of the program's spans and counters share.

The program (`genome_tpu_torch/assemble/metrics.py`) writes a span as
{"event": "span", "name", "parent", "run", "t0", "t1"} in time.time()
seconds, with "device_ms" (CUDA events, null where not read) for a device
span, and its counters as fields of each phase_end event: `syncs`,
`sync_wait_s`, `retries`, `h2d_bytes`. Each helper sums within a job,
every occurrence (retries included), and takes the mean over the jobs
that logged the span or counter; None where no job did, as in a program
that writes neither."""

from __future__ import annotations

import statistics


def span_ms(rec: dict, names, device: bool = False) -> float | None:
    """Mean a job of the summed host walls (device=False) or device_ms
    (device=True, spans whose device time was read) of the spans named
    `names`, in ms."""
    out = []
    for job in rec["jobs"]:
        vals = [e["device_ms"] if device else 1e3 * (e["t1"] - e["t0"])
                for e in job["events"]
                if e.get("event") == "span" and e.get("name") in names
                and (not device or e.get("device_ms") is not None)]
        if vals:
            out.append(sum(vals))
    return statistics.fmean(out) if out else None


def counter_mean(rec: dict, field: str, phase: str | None = None,
                 scale: float = 1.0) -> float | None:
    """Mean a job of a counter summed over its phase_end events (those of
    `phase` only, where given), times `scale`."""
    out = []
    for job in rec["jobs"]:
        vals = [e[field] for e in job["events"]
                if e.get("event") == "phase_end" and field in e
                and (phase is None or e.get("phase") == phase)]
        if vals:
            out.append(sum(vals))
    return scale * statistics.fmean(out) if out else None
