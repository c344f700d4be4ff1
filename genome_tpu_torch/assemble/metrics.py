"""Structured metrics, spans and counters (SURVEY.md §5.5).

JSONL events (phase, wall seconds, throughput, sizes) — exactly the
quantities the baseline grades (k-mers/s/chip, reads/s; BASELINE.json:2).

`Metrics.phase` times one stage of a job and makes its Metrics current
(a context variable), so code below it opens spans and adds to counters
without a `metrics` argument:

- `span(name, device=None)` times a piece of work inside the phase. Under
  an active torch.profiler session it is also a `record_function` range,
  a `user_annotation` on the calling thread in the profiler's own clock.
  With a CUDA `device` it also records a pair of CUDA events on the
  current stream, resolved when the phase ends (after the phase's own
  host read; a pair not yet complete reads null, never waited for). A
  span event is {"event": "span", "name", "parent", "run", "t0", "t1"}
  (+ "device_ms"), `parent` the enclosing span, else the phase, and is
  written with the phase's `phase_end`.
- `count(name, n)` and `host_read(site, fn)` add to the phase's
  counters, which its `phase_end` carries as fields: `syncs` (host reads
  of device data), `sync_wait_s` (host seconds blocked in them),
  `retries` (work redone after an overflow or taken by a fallback),
  `h2d_bytes` (host-to-device copies) and `sync_sites` (reads by site);
  the extraction adds `extract_chunks` (code chunks through the packed
  entry: on the card, one launch of the extraction kernel each), the
  emission `d2h_bytes` (its copies to the host) and `contigs_reversed`
  (contigs it wrote reverse-complemented).

With no current Metrics a span is only the profiler range (its `wall_s`
is still set: it times the block either way), and counters are dropped.
Times are to the microsecond.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import json
import sys
import time
import uuid

import torch
from torch.profiler import record_function

COUNTERS = ("syncs", "sync_wait_s", "retries", "h2d_bytes")

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "genome_tpu_torch_phase", default=None)


class _Phase:
    """An open phase: its counters, its spans and the open span names."""

    __slots__ = ("run", "name", "counters", "sites", "spans", "timed",
                 "stack")

    def __init__(self, run: str, name: str):
        self.run = run
        self.name = name
        self.counters = dict.fromkeys(COUNTERS, 0)
        self.sites: collections.Counter = collections.Counter()
        self.spans: list[dict] = []
        self.timed: list = []  # (span event, start event, end event)
        self.stack: list[str] = []


class Metrics:
    def __init__(self, path: str | None = None, stream=None, quiet: bool = False):
        self._f = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stderr
        self._quiet = quiet
        self.events: list[dict] = []
        self.run = uuid.uuid4().hex[:12]
        self._open: list[_Phase] = []

    def _write(self, rec: dict) -> None:
        self.events.append(rec)
        if self._f:
            self._f.write(json.dumps(rec, sort_keys=True) + "\n")

    def log(self, event: str, ts: float | None = None, **fields) -> None:
        rec = {"ts": round(time.time() if ts is None else ts, 6),
               "event": event, **fields}
        self._write(rec)
        if self._f:
            self._f.flush()
        if not self._quiet:
            print(f"[genome_tpu_torch] {event}: " + " ".join(
                f"{k}={v}" for k, v in fields.items()), file=self._stream)

    @contextlib.contextmanager
    def phase(self, name: str, **fields):
        self.log("phase_start", phase=name, **fields)
        ph = _Phase(self.run, name)
        self._open.append(ph)
        token = _CURRENT.set(ph)
        w0, t0 = time.time(), time.perf_counter()
        info: dict = {}
        try:
            yield info
        finally:
            dt = time.perf_counter() - t0
            _CURRENT.reset(token)
            self._open.pop()
            for rec, a, b in ph.timed:
                rec["device_ms"] = round(a.elapsed_time(b), 6) \
                    if b.query() else None
            for rec in ph.spans:
                self._write(rec)
            fields = dict(ph.counters, sync_sites=dict(ph.sites), **info)
            fields["sync_wait_s"] = round(fields["sync_wait_s"], 6)
            self.log("phase_end", ts=w0 + dt, phase=name,
                     wall_s=round(dt, 6), **fields)

    def span(self, name: str, device=None) -> "_Span":
        """A span of this Metrics' innermost open phase, whichever Metrics
        is current (only the profiler range when none is open)."""
        return _Span(name, device, self)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class _Span:
    """The context manager of `span`; `wall_s` is set on exit."""

    __slots__ = ("name", "device", "metrics", "phase", "parent", "rf",
                 "ev0", "w0", "p0", "wall_s")

    def __init__(self, name: str, device, metrics: Metrics | None):
        self.name = name
        self.device = device
        self.metrics = metrics
        self.wall_s = None

    def __enter__(self) -> "_Span":
        if self.metrics is None:
            ph = _CURRENT.get()
        else:
            ph = self.metrics._open[-1] if self.metrics._open else None
        self.phase = ph
        self.ev0 = None
        if ph is not None:
            self.parent = ph.stack[-1] if ph.stack else ph.name
            ph.stack.append(self.name)
            dev = self.device
            if dev is not None and torch.device(dev).type == "cuda":
                self.ev0 = torch.cuda.Event(enable_timing=True)
                self.ev0.record()
        self.rf = record_function(self.name) \
            if torch.autograd._profiler_enabled() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.w0, self.p0 = time.time(), time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.wall_s = dt = time.perf_counter() - self.p0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        ph = self.phase
        if ph is None:
            return False
        ph.stack.pop()
        rec = {"event": "span", "name": self.name, "parent": self.parent,
               "run": ph.run, "t0": round(self.w0, 6),
               "t1": round(self.w0 + dt, 6)}
        if self.device is not None:
            rec["device_ms"] = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            ph.timed.append((rec, self.ev0, ev1))
        ph.spans.append(rec)
        return False


def span(name: str, device=None) -> _Span:
    """Time the block as a span of the current phase (see the module
    docstring). device: the torch device the block's work runs on; on a
    CUDA device the span also reads the device time between its ends."""
    return _Span(name, device, None)


def count(name: str, n=1) -> None:
    """Add n to the current phase's counter `name`."""
    ph = _CURRENT.get()
    if ph is not None:
        ph.counters[name] = ph.counters.get(name, 0) + n


def host_read(site: str, fn):
    """fn(), an existing host read of device data (`.tolist()`, `bool(t)`,
    `.cpu()`, a synchronize), counted as one sync of the current phase
    with the host seconds it blocked. Adds no read of its own."""
    ph = _CURRENT.get()
    if ph is None:
        return fn()
    t0 = time.perf_counter()
    out = fn()
    c = ph.counters
    c["syncs"] += 1
    c["sync_wait_s"] += time.perf_counter() - t0
    ph.sites[site] += 1
    return out
