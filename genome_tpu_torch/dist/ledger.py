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

`summary()` keeps the JAX keys and numbers: a key costs 8 bytes on the
wire in both (two uint32 there, one int64 here), a response 4, and the
sharded simplify's columns are JAX's 32-bit words. Of each
all_to_all buffer, (S-1)/S leaves the rank. The host agreements
(all_max, all_any) stand in for JAX's host reads of a gathered flag and
are not counted, as JAX does not count those. One ledger belongs to one
run: the caller creates it and passes it down.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class _ProgramCost:
    a2a: int = 0            # all_to_all launches per invocation
    bytes: int = 0          # bytes sent per rank, all a2as summed

    def as_dict(self, cross: float) -> dict:
        # psum and the round-capped dyn_* stay 0 until a program with a
        # psum or an early-exit loop (the sharded final state) records them
        return {
            "a2a": self.a2a,
            "psum": 0,
            "mb_per_shard": round(self.bytes / 1e6, 3),
            "mb_crossing": round(self.bytes * cross / 1e6, 3),
            "dyn_a2a_cap": 0,
            "dyn_mb_cap": 0.0,
        }


class ExchangeLedger:
    def __init__(self):
        self.programs: dict[str, _ProgramCost] = {}
        self.invocations: dict[str, int] = {}
        self.archived: dict[str, list] = {}
        self._keys: dict[str, object] = {}
        self._current: str | None = None
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
        self.programs[name] = _ProgramCost()

    def record_a2a(self, num_shards: int, nbytes: int) -> None:
        """One all_to_all that sends `nbytes` from this rank."""
        if self._current is None:
            return
        self.num_shards = num_shards
        c = self.programs[self._current]
        c.a2a += 1
        c.bytes += nbytes

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
