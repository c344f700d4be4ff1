"""Tiny oracle: pure-Python, string/dict de novo assembler.

The port's own copy of genome_tpu/golden/tiny.py. Maximum-clarity
implementation of SEMANTICS.md, used only in tests to validate the NumPy
golden assembler (which in turn validates the device pipeline). Reference
pipeline shape: BASELINE.json:5 (count -> de Bruijn graph ->
tips/bubbles/compaction -> contigs). O(N) dicts — small inputs only.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass

from genome_tpu_torch.params import AssemblyParams
from genome_tpu_torch.utils.dna import revcomp_str as rc

_ACGT = set("ACGT")


def _canon(s: str) -> str:
    return min(s, rc(s))


def count_kmers(reads: list[str], k: int) -> Counter:
    """Canonical k-mer multiplicities; windows with non-ACGT dropped (§2)."""
    c: Counter = Counter()
    for r in reads:
        r = r.upper()
        for i in range(len(r) - k + 1):
            w = r[i : i + k]
            if set(w) <= _ACGT:
                c[_canon(w)] += 1
    return c


@dataclass
class _Chain:
    nodes: list[str]  # oriented k-mer strings, in path order
    is_cycle: bool

    @property
    def head(self) -> str:
        return self.nodes[0]

    @property
    def tail(self) -> str:
        return self.nodes[-1]


class _Graph:
    """Alive canonical k-mer set + oriented probing (SEMANTICS §3)."""

    def __init__(self, counts: dict[str, int]):
        self.counts = counts
        self.alive: set[str] = set(counts)

    def succs(self, v: str) -> list[str]:
        out = []
        for b in "ACGT":
            w = v[1:] + b
            if _canon(w) in self.alive:
                out.append(w)
        return out

    def outdeg(self, v: str) -> int:
        return len(self.succs(v))

    def indeg(self, v: str) -> int:
        return self.outdeg(rc(v))

    def next_unique(self, v: str) -> str | None:
        s = self.succs(v)
        if len(s) == 1 and self.indeg(s[0]) == 1:
            return s[0]
        return None

    def prev_unique(self, v: str) -> str | None:
        w = self.next_unique(rc(v))
        return rc(w) if w is not None else None


    def chains(self) -> list[_Chain]:
        """Partition alive oriented nodes into path chains + cycles (§4)."""
        nodes = []
        for km in self.alive:
            nodes.append(km)
            nodes.append(rc(km))
        visited: set[str] = set()
        chains: list[_Chain] = []
        # path chains from heads
        for v in nodes:
            if self.prev_unique(v) is None:
                path = [v]
                visited.add(v)
                cur = v
                while True:
                    nxt = self.next_unique(cur)
                    if nxt is None or nxt in visited:
                        break
                    path.append(nxt)
                    visited.add(nxt)
                    cur = nxt
                chains.append(_Chain(path, is_cycle=False))
        # cycles: whatever is left; head = min oriented id (§4)
        for v in nodes:
            if v in visited:
                continue
            cyc = [v]
            visited.add(v)
            cur = self.next_unique(v)
            while cur != v:
                cyc.append(cur)
                visited.add(cur)
                cur = self.next_unique(cur)
            # cycle head = min oriented k-mer value (string order == packed
            # value order), layout-independent (SEMANTICS §4)
            h = min(range(len(cyc)), key=lambda i: cyc[i])
            chains.append(_Chain(cyc[h:] + cyc[:h], is_cycle=True))
        return chains

    def twin_head(self, ch: _Chain) -> str:
        if not ch.is_cycle:
            return rc(ch.tail)
        return min(rc(v) for v in ch.nodes)

    def is_primary(self, ch: _Chain) -> bool:
        return ch.head <= self.twin_head(ch)

    def kill_chain(self, ch: _Chain) -> None:
        for v in ch.nodes:
            self.alive.discard(_canon(v))

    def coverage(self, ch: _Chain) -> int:
        return sum(self.counts[_canon(v)] for v in ch.nodes)


def _clip_tips(g: _Graph, tip_len: int) -> bool:
    """SEMANTICS §5: exactly-one-open-end path chains of len <= tip_len."""
    doomed: list[_Chain] = []
    for ch in g.chains():
        if ch.is_cycle or len(ch.nodes) > tip_len:
            continue
        start_open = g.indeg(ch.head) == 0
        end_open = g.outdeg(ch.tail) == 0
        if start_open != end_open:
            doomed.append(ch)
    for ch in doomed:
        g.kill_chain(ch)
    return bool(doomed)


def _pop_bubbles(g: _Graph, bubble_len: int) -> bool:
    """SEMANTICS §5: parallel short chains keyed by (pred(head), succ(tail))."""
    groups: dict[tuple[str, str], list[_Chain]] = defaultdict(list)
    for ch in g.chains():
        if ch.is_cycle or len(ch.nodes) > bubble_len:
            continue
        if g.indeg(ch.head) != 1 or g.outdeg(ch.tail) != 1:
            continue
        p = rc(g.succs(rc(ch.head))[0])  # unique predecessor of head
        s = g.succs(ch.tail)[0]          # unique successor of tail
        groups[(p, s)].append(ch)

    changed = False
    for (p, s), members in groups.items():
        if (p, s) > (rc(s), rc(p)):  # direction pin (§5)
            continue
        # Self-RC-keyed group (p == rc(s)): both RC twins of every side are
        # members; dedupe by keeping only primary chains (§5 dedupe pin).
        if p == rc(s):
            sides = [ch for ch in members if g.is_primary(ch)]
        else:
            sides = members
        if len(sides) < 2:
            continue
        sides.sort(key=lambda ch: (-g.coverage(ch), ch.head))
        for ch in sides[1:]:
            g.kill_chain(ch)
        changed = True
    return changed


def _emit(g: _Graph, params: AssemblyParams) -> list[str]:
    contigs = []
    for ch in g.chains():
        if not g.is_primary(ch):
            continue
        seq = ch.head + "".join(v[-1] for v in ch.nodes[1:])
        contigs.append(_canon(seq))
    contigs = [c for c in contigs if len(c) >= params.min_contig_len]
    return sorted(contigs)


def assemble(reads: list[str], params: AssemblyParams | None = None) -> list[str]:
    """reads -> sorted canonical contig list, per SEMANTICS.md."""
    params = params or AssemblyParams()
    counts = count_kmers(reads, params.k)
    counts = {km: c for km, c in counts.items() if c >= params.min_coverage}
    g = _Graph(counts)
    for _ in range(params.max_rounds):
        changed = _clip_tips(g, params.tip_len_eff)
        changed |= _pop_bubbles(g, params.bubble_len_eff)
        if not changed:
            break
    return _emit(g, params)
