"""Helpers the metric readers share over a run's record.

A record is a dict: `setup_s`, `window_s`, `peak_bytes`, `jobs` (each
with `wall_s`, `bases`, `isolate` and `events`, the program's Metrics
events of that job), `launches` (the program's kernel launch counters
over the window) and, in a `--trace 1` run, `trace` (trace.summarize)."""

from __future__ import annotations

import statistics

PHASES = ("read_input", "count", "build", "simplify", "contigs")


def phase_values(rec: dict, phase: str, field: str = "wall_s") -> list[float]:
    """Per job that logged `phase`: the sum of `field` over its phase_end
    events of that phase."""
    out = []
    for job in rec["jobs"]:
        ev = [e[field] for e in job["events"]
              if e.get("event") == "phase_end" and e.get("phase") == phase
              and field in e]
        if ev:
            out.append(float(sum(ev)))
    return out


def phase_ms(rec: dict, phase: str, field: str = "wall_s") -> float | None:
    """Mean of a phase's wall (or another field of its phase_end event)
    a job, in ms; None where no job logged it."""
    values = phase_values(rec, phase, field)
    return 1e3 * statistics.fmean(values) if values else None


# the names the phases' spans take in a trace's idle gaps (the dist ones
# as BENCHMARK.json names their layers)
SPAN_NAMES = {"read_input": "parse", "count": "count", "build": "build",
              "simplify": "simplify", "dist_extract": "dist extraction",
              "dist_count": "dist count", "dist_build": "dist build",
              "dist_simplify_sharded": "dist simplify",
              "dist_simplify": "dist simplify",
              "dist_final_sharded": "dist final state",
              "dist_contigs": "dist emission"}


def spans(rec: dict) -> list[tuple[float, float, str]]:
    """(start, end, name) in time.time() seconds of every job of the window
    and of its logged phases (the final state and the emission as two
    parts of `contigs`), from the Metrics events (times to 1 ms)."""
    out = []
    for job in rec["jobs"]:
        out.append((job["t0_wall"], job["t1_wall"], "job, outside phases"))
        for e in job["events"]:
            if e.get("event") != "phase_end" or "ts" not in e:
                continue
            a = e["ts"] - e["wall_s"]
            if e["phase"] in SPAN_NAMES:
                out.append((a, e["ts"], SPAN_NAMES[e["phase"]]))
            elif e["phase"] == "contigs":
                f = a + e.get("final_s", 0.0)
                out.append((a, f, "final state"))
                out.append((f, e["ts"], "emission"))
    return out
