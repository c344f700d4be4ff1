"""Exchange ledger: per-program collective and byte accounting (port of
genome_tpu/dist/ledger.py; SURVEY §5.5).

The JAX ledger records each sharded program's exchanges once, while the
program is traced, and multiplies them by the host's invocation count.
The port has no trace, so a program records its all_to_alls as it runs:
`program(name, key)` opens each call, with `key` what fixes the
program's exchanges (its caps), as a trace's static arguments fix them in
JAX. The first call at a key records the bytes its exchanges send; a
later call at the same key (a sharded simplify pass, once a round) counts
one more invocation of that cost, as a jitted program called again does.
A call at a new key (a capacity retry, a slack rung) archives the cost
and invocations before it as a retry epoch, as a JAX retrace archives
them. The caller counts each call with `invoke(name)`.

An early-exit loop (the sharded final state's doubling phases, a JAX
`while_loop` under `loop(cap, dynamic=True)`) is costed as JAX traces
it: `loop(cap)` records its first round's all_to_alls and psums `cap`
times, into `a2a`/`mb_*` and into `dyn_a2a_cap`/`dyn_mb_cap`, and its
later rounds record nothing; the rounds observed leave through the
caller's own event. `record_psum()` counts one agreed exit test (a JAX
psum). The other programs record neither, and keep `psum` and `dyn_*`
at 0, as in JAX.

`summary()` keeps the JAX keys and numbers: a key costs 8 bytes on the
wire in both (two uint32 there, one int64 here), a response 4, and the
sharded simplify's columns are JAX's 32-bit words. Of each
all_to_all buffer, (S-1)/S leaves the rank. The host agreements
(all_max, all_any) stand in for JAX's host reads of a gathered flag and
are not counted, as JAX does not count those. One ledger belongs to one
run: the caller creates it and passes it down.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass


@dataclass
class _ProgramCost:
    a2a: int = 0            # all_to_all launches per invocation
    bytes: int = 0          # bytes sent per rank, all a2as summed
    psum: int = 0           # agreed exit tests per invocation
    dyn_a2a: int = 0        # the part of a2a under early-exit loops,
    dyn_bytes: int = 0      # at their round caps

    def as_dict(self, cross: float) -> dict:
        return {
            "a2a": self.a2a,
            "psum": self.psum,
            "mb_per_shard": round(self.bytes / 1e6, 3),
            "mb_crossing": round(self.bytes * cross / 1e6, 3),
            "dyn_a2a_cap": self.dyn_a2a,
            "dyn_mb_cap": round(self.dyn_bytes / 1e6, 3),
        }


class ExchangeLedger:
    def __init__(self):
        self.programs: dict[str, _ProgramCost] = {}
        self.invocations: dict[str, int] = {}
        self.archived: dict[str, list] = {}
        self._keys: dict[str, object] = {}
        self._current: str | None = None
        self._loop_cap = 0      # the open early-exit loop's cap, or 0
        self.num_shards = 0

    def program(self, name: str, key) -> None:
        """Open a call of program `name` at `key` (its caps). At the key of
        the program's last call nothing is recorded again; at a new key
        the (cost, invocations) before it are archived as a retry epoch
        (if counted) and a fresh cost records this call's exchanges."""
        if name in self.programs and self._keys[name] == key:
            self._current = None
            return
        if name in self.programs and self.invocations.get(name, 0) > 0:
            self.archived.setdefault(name, []).append(
                (self.programs[name], self.invocations[name]))
            self.invocations[name] = 0
        self._keys[name] = key
        self._current = name
        self._loop_cap = 0
        self.programs[name] = _ProgramCost()

    @contextlib.contextmanager
    def loop(self, cap: int):
        """An early-exit loop of at most `cap` rounds (JAX's
        `loop(cap, dynamic=True)` around a while_loop). Yields
        `round_done`, which the caller calls at the end of each round:
        the first round's records count `cap` times, the later rounds'
        not at all."""
        current = self._current
        self._loop_cap = max(1, int(cap))

        def round_done():
            self._current = None
        try:
            yield round_done
        finally:
            self._current, self._loop_cap = current, 0

    def record_a2a(self, num_shards: int, nbytes: int) -> None:
        """One all_to_all that sends `nbytes` from this rank."""
        if self._current is None:
            return
        self.num_shards = num_shards
        c = self.programs[self._current]
        mult = self._loop_cap or 1
        c.a2a += mult
        c.bytes += nbytes * mult
        if self._loop_cap:
            c.dyn_a2a += mult
            c.dyn_bytes += nbytes * mult

    def record_psum(self) -> None:
        """One agreed exit test (a JAX psum)."""
        if self._current is not None:
            self.programs[self._current].psum += self._loop_cap or 1

    def invoke(self, name: str) -> None:
        self.invocations[name] = self.invocations.get(name, 0) + 1

    def summary(self) -> dict:
        S = self.num_shards
        cross = (S - 1) / S if S > 1 else 0.0
        out = {}
        tot_a2a = tot_mb = 0.0
        for name, cost in self.programs.items():
            inv = self.invocations.get(name, 0)
            d = cost.as_dict(cross)
            d["invocations"] = inv
            epochs = self.archived.get(name, [])
            if epochs:
                d["retry_epochs"] = len(epochs)
            out[name] = d
            tot_a2a += d["a2a"] * inv
            tot_mb += d["mb_crossing"] * inv
            for old_cost, old_inv in epochs:
                od = old_cost.as_dict(cross)
                tot_a2a += od["a2a"] * old_inv
                tot_mb += od["mb_crossing"] * old_inv
        out["_totals"] = {"a2a_invoked": int(tot_a2a),
                          "mb_crossing_invoked": round(tot_mb, 3),
                          "num_shards": S}
        return out
