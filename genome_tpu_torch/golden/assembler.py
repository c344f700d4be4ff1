"""Golden NumPy assembler: vectorized CPU implementation of SEMANTICS.md.

The port's own copy of genome_tpu/golden/assembler.py, the parity oracle
for the device pipeline (SURVEY.md §7 milestone 1, BASELINE.json:7
"single-host CPU reference run"). It imports only the port's params and
utils.dna: no torch and nothing of the port's kernels or graph, so it
stays independent of the code it checks. It mirrors the reference
pipeline (count -> de Bruijn -> simplify -> contigs, BASELINE.json:5) with
array algorithms: sort/unique counting (replacing the reference `DNAMap`
open-addressing inserts), binary-search successor probing, and
pointer-doubling chain computation — structurally the same algorithms the
device path uses, but independently implemented and validated against the
pure-Python tiny oracle.
"""

from __future__ import annotations

import numpy as np

from genome_tpu_torch.params import AssemblyParams
from genome_tpu_torch.utils import dna

_U64 = np.uint64


def count_canonical_kmers(
    reads: list[str] | "object",
    k: int,
    min_coverage: int = 1,
    chunk_kmers: int = 1 << 24,
) -> tuple[np.ndarray, np.ndarray]:
    """Reads -> (sorted unique canonical k-mers u64, counts i64), filtered.

    Accepts a list of strings or any iterable of strings; streams in chunks
    so memory stays bounded by the unique set + one chunk.
    """
    pending: list[np.ndarray] = []
    pending_n = 0
    uniq = np.empty(0, dtype=_U64)
    cnts = np.empty(0, dtype=np.int64)

    def _merge():
        nonlocal uniq, cnts, pending, pending_n
        if not pending:
            return
        raw = np.concatenate(pending)
        pending, pending_n = [], 0
        u, c = np.unique(raw, return_counts=True)
        allk = np.concatenate([uniq, u])
        allc = np.concatenate([cnts, c.astype(np.int64)])
        order = np.argsort(allk, kind="stable")
        allk, allc = allk[order], allc[order]
        if allk.size:
            boundary = np.empty(allk.size, dtype=bool)
            boundary[0] = True
            boundary[1:] = allk[1:] != allk[:-1]
            idx = np.cumsum(boundary) - 1
            uniq = allk[boundary]
            cnts = np.zeros(uniq.size, dtype=np.int64)
            np.add.at(cnts, idx, allc)

    for r in reads:
        km = dna.canonical_kmers_of_read(r, k)
        if km.size:
            pending.append(km)
            pending_n += km.size
        if pending_n >= chunk_kmers:
            _merge()
    _merge()

    keep = cnts >= min_coverage
    return uniq[keep], cnts[keep]


class Graph:
    """De Bruijn graph over sorted canonical k-mers (SEMANTICS §3-§5)."""

    def __init__(self, kmers: np.ndarray, counts: np.ndarray, k: int):
        self.k = k
        self.kmers = np.asarray(kmers, dtype=_U64)
        self.counts = np.asarray(counts, dtype=np.int64)
        n = self.kmers.size
        self.n = n
        self.alive = np.ones(n, dtype=bool)
        # oriented k-mer values: okv[2i] = kmer_i, okv[2i+1] = rc(kmer_i)
        self.okv = np.empty(2 * n, dtype=_U64)
        self.okv[0::2] = self.kmers
        self.okv[1::2] = dna.revcomp_u64(self.kmers, k)
        self.succ = self._build_succ()  # [2n, 4] int64, -1 = absent

    def _build_succ(self) -> np.ndarray:
        k, n = self.k, self.n
        mask = dna.kmer_mask(k)
        succ = np.full((2 * n, 4), -1, dtype=np.int64)
        shifted = (self.okv << _U64(2)) & mask
        for b in range(4):
            ext = shifted | _U64(b)
            rc = dna.revcomp_u64(ext, k)
            extc = np.minimum(ext, rc)
            j = np.searchsorted(self.kmers, extc)
            j_clip = np.minimum(j, max(n - 1, 0))
            found = (j < n) & (self.kmers[j_clip] == extc) if n else np.zeros(2 * n, bool)
            orient = (ext != extc).astype(np.int64)
            succ[:, b] = np.where(found, 2 * j_clip + orient, -1)
        return succ

    # --- degrees / unique links (recomputed against current alive mask) ---

    def _state(self):
        """Returns (outdeg, usucc, next_u, prev_u) over oriented nodes."""
        alive_o = np.repeat(self.alive, 2)
        tgt = self.succ  # [2n,4]
        ok = (tgt >= 0) & alive_o[np.clip(tgt, 0, None)] & alive_o[:, None]
        outdeg = ok.sum(axis=1)
        usucc = np.where(ok, tgt, -1).max(axis=1)  # valid when outdeg==1
        has_next = (outdeg == 1)
        w = np.where(has_next, usucc, 0)
        indeg_w = outdeg[w ^ 1]
        next_u = np.where(has_next & (indeg_w == 1), w, -1)
        prev_u = np.where(next_u[np.arange(2 * self.n) ^ 1] >= 0,
                          next_u[np.arange(2 * self.n) ^ 1] ^ 1, -1)
        return outdeg, usucc, next_u, prev_u

    def chains(self):
        """Chain decomposition by pointer doubling (SEMANTICS §4).

        Returns dict of per-oriented-node arrays head/dist and per-node flags,
        restricted to alive nodes (dead nodes: head == -1).
        """
        n2 = 2 * self.n
        ids = np.arange(n2, dtype=np.int64)
        outdeg, usucc, next_u, prev_u = self._state()
        alive_o = np.repeat(self.alive, 2)

        rounds = max(1, int(np.ceil(np.log2(max(n2, 2)))) + 1)
        p = np.where(prev_u >= 0, prev_u, ids)
        # phase 1: converge paths; detect cycles
        q = p.copy()
        for _ in range(rounds):
            q = q[q]
        in_cycle = alive_o & (prev_u[q] >= 0)
        # cycle head: node with min oriented k-mer value (SEMANTICS §4;
        # value-based so independent of table layout). Min-doubling carrying
        # (value, node id); okv values are unique so the argmin is unique.
        if in_cycle.any():
            mn_v = self.okv.copy()
            mn_i = ids.copy()
            qq = p.copy()
            for _ in range(rounds):
                cand_v, cand_i = mn_v[qq], mn_i[qq]
                take = cand_v < mn_v
                mn_v = np.where(take, cand_v, mn_v)
                mn_i = np.where(take, cand_i, mn_i)
                qq = qq[qq]
            # phase 2: break each cycle at its head
            prev2 = prev_u.copy()
            prev2[in_cycle & (mn_i == ids)] = -1
        else:
            prev2 = prev_u
        p = np.where(prev2 >= 0, prev2, ids)
        d = np.where(prev2 >= 0, 1, 0).astype(np.int64)
        for _ in range(rounds):
            d = d + d[p]
            p = p[p]
        head = np.where(alive_o, p, -1)
        dist = np.where(alive_o, d, 0)

        is_head = alive_o & (head == ids)
        # chain length, tail, coverage, cycle flag (indexed by head id)
        length = np.zeros(n2, dtype=np.int64)
        np.maximum.at(length, head[alive_o], dist[alive_o] + 1)
        cyc_head = np.zeros(n2, dtype=bool)
        if in_cycle.any():
            cyc_head[head[in_cycle]] = True
        tail_of = np.full(n2, -1, dtype=np.int64)
        is_tail = alive_o & (next_u == -1)
        tail_of[head[is_tail]] = ids[is_tail]
        cov = np.zeros(n2, dtype=np.int64)
        np.add.at(cov, head[alive_o], self.counts[ids[alive_o] >> 1])
        # twin-head okv value: okv(rc(tail)) for paths; min okv over the RC
        # node set for cycles (SEMANTICS §4 — values, not ids)
        twin_okv = np.zeros(n2, dtype=_U64)
        ok_t = is_head & ~cyc_head & (tail_of >= 0)
        twin_okv[ok_t] = self.okv[tail_of[ok_t] ^ 1]
        if in_cycle.any():
            tw = np.full(n2, np.iinfo(np.uint64).max, dtype=_U64)
            np.minimum.at(tw, head[in_cycle], self.okv[ids[in_cycle] ^ 1])
            twin_okv[is_head & cyc_head] = tw[is_head & cyc_head]
        return {
            "outdeg": outdeg, "usucc": usucc, "next_u": next_u,
            "head": head, "dist": dist, "is_head": is_head,
            "length": length, "tail_of": tail_of, "cov": cov,
            "twin_okv": twin_okv, "cyc_head": cyc_head, "alive_o": alive_o,
        }

    def _kill_heads(self, st, doomed_heads_mask: np.ndarray) -> None:
        """Mark dead every canonical node whose chain head is doomed."""
        alive_o = st["alive_o"]
        node_doomed = alive_o & doomed_heads_mask[np.clip(st["head"], 0, None)] \
            & (st["head"] >= 0)
        self.alive[np.unique(np.arange(2 * self.n)[node_doomed] >> 1)] = False

    # --- simplification passes (SEMANTICS §5) ---

    def clip_tips(self, tip_len: int) -> bool:
        st = self.chains()
        is_head, length = st["is_head"], st["length"]
        h = np.arange(2 * self.n)
        cand = is_head & ~st["cyc_head"] & (length <= tip_len)
        if not cand.any():
            return False
        start_open = st["outdeg"][h ^ 1] == 0            # indeg(head) == 0
        tails = st["tail_of"]
        end_open = np.zeros(2 * self.n, dtype=bool)
        valid_tail = tails >= 0
        end_open[valid_tail] = st["outdeg"][tails[valid_tail]] == 0
        doomed = cand & (start_open != end_open)
        if not doomed.any():
            return False
        self._kill_heads(st, doomed)
        return True

    def pop_bubbles(self, bubble_len: int) -> bool:
        st = self.chains()
        n2 = 2 * self.n
        ids = np.arange(n2)
        is_head, length, tails = st["is_head"], st["length"], st["tail_of"]
        outdeg, usucc = st["outdeg"], st["usucc"]
        indeg_head = outdeg[ids ^ 1]
        cand = is_head & ~st["cyc_head"] & (length <= bubble_len) & (indeg_head == 1)
        valid_tail = tails >= 0
        tail_out1 = np.zeros(n2, dtype=bool)
        tail_out1[valid_tail] = outdeg[tails[valid_tail]] == 1
        cand &= tail_out1
        hs = ids[cand]
        if hs.size < 2:
            return False
        p = usucc[hs ^ 1] ^ 1         # unique predecessor of head
        s = usucc[tails[hs]]          # unique successor of tail
        okv = self.okv
        # direction pin: (okv[p],okv[s]) <= (okv[s^1],okv[p^1]) lex
        proc = (okv[p] < okv[s ^ 1]) | ((okv[p] == okv[s ^ 1]) & (okv[s] <= okv[p ^ 1]))
        # twin-dedupe pin for self-RC keyed groups (p == rc(s))
        selfrc = p == (s ^ 1)
        primary = okv[hs] <= st["twin_okv"][hs]
        keep_member = proc & (~selfrc | primary)
        hs, p, s = hs[keep_member], p[keep_member], s[keep_member]
        if hs.size < 2:
            return False
        cov = st["cov"][hs]
        # group by (p,s); within group order by (-cov, okv[head]); first kept
        order = np.lexsort((okv[hs], -cov, s, p))
        hs, p, s, cov = hs[order], p[order], s[order], cov[order]
        new_grp = np.empty(hs.size, dtype=bool)
        new_grp[0] = True
        new_grp[1:] = (p[1:] != p[:-1]) | (s[1:] != s[:-1])
        grp_id = np.cumsum(new_grp) - 1
        grp_size = np.bincount(grp_id)
        in_bubble = grp_size[grp_id] >= 2
        doomed_list = hs[in_bubble & ~new_grp]
        if doomed_list.size == 0:
            return False
        doomed = np.zeros(n2, dtype=bool)
        doomed[doomed_list] = True
        self._kill_heads(st, doomed)
        return True

    # --- emission (SEMANTICS §6) ---

    def contigs(self) -> list[str]:
        st = self.chains()
        n2 = 2 * self.n
        ids = np.arange(n2)
        is_head = st["is_head"]
        primary = is_head & (self.okv[ids] <= st["twin_okv"])
        alive_o = st["alive_o"]
        sel = alive_o & primary[np.clip(st["head"], 0, None)] & (st["head"] >= 0)
        if not sel.any():
            return []
        vh, vd, vid = st["head"][sel], st["dist"][sel], ids[sel]
        order = np.lexsort((vd, vh))
        vh, vd, vid = vh[order], vd[order], vid[order]
        starts = np.flatnonzero(np.concatenate([[True], vh[1:] != vh[:-1]]))
        ends = np.concatenate([starts[1:], [vh.size]])
        last_base = (self.okv & _U64(3)).astype(np.uint8)
        out: list[str] = []
        for a, b in zip(starts, ends):
            head_km = dna.kmer_to_str(int(self.okv[vh[a]]), self.k)
            tail_bases = dna.decode(last_base[vid[a + 1 : b]])
            seq = head_km + tail_bases
            out.append(min(seq, dna.revcomp_str(seq)))
        return out


def assemble(reads: list[str], params: AssemblyParams | None = None) -> list[str]:
    """reads -> sorted canonical contig list, per SEMANTICS.md."""
    params = params or AssemblyParams()
    kmers, counts = count_canonical_kmers(reads, params.k, params.min_coverage)
    g = Graph(kmers, counts, params.k)
    for _ in range(params.max_rounds):
        changed = g.clip_tips(params.tip_len_eff)
        changed |= g.pop_bubbles(params.bubble_len_eff)
        if not changed:
            break
    contigs = [c for c in g.contigs() if len(c) >= params.min_contig_len]
    return sorted(contigs)
