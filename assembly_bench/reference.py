"""Plain PyTorch reference assembler: reads -> contigs by SEMANTICS.md.

The benchmark's own yardstick for `correct`. It imports torch and numpy
only, nothing of the program under test, and takes nothing the program
made: it reads the same uint8 code matrix the harness handed to the
program (codes 0-3 = ACGT, 4 = invalid) and works the contigs out again.
Its array algorithms follow the NumPy golden oracle's (sort/unique
counting, binary-search successor probing, pointer-doubling chains) in
plain torch operations, so it runs on the card in seconds where the NumPy
oracle takes minutes. Packed k-mers are int64 (first base at the most
significant bits); k <= 31 keeps every value positive.

`control=True` breaks one guarantee the configurations state: a bubble
keeps its side by the smaller head k-mer alone, ignoring which side has
the higher k-mer count sum. It is the benchmark's control (control.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_I64_MAX = torch.iinfo(torch.int64).max
_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
_RC = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (int64)."""
    y = x ^ ((1 << (2 * k)) - 1)
    out = torch.zeros_like(x)
    for _ in range(k):
        out = (out << 2) | (y & 3)
        y = y >> 2
    return out


def canonical_kmers(codes: np.ndarray, k: int, device,
                    block_rows: int = 1 << 19) -> torch.Tensor:
    """Every window's canonical k-mer (windows with a code >= 4 dropped),
    in row blocks."""
    if k > 31 or k % 2 == 0:
        raise ValueError(f"reference needs odd k <= 31, got {k}")
    R, L = codes.shape
    W = L - k + 1
    if W <= 0 or R == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    parts = []
    for r0 in range(0, R, block_rows):
        c = torch.from_numpy(np.ascontiguousarray(
            codes[r0 : r0 + block_rows])).to(device).to(torch.int64)
        fw = torch.zeros((c.shape[0], W), dtype=torch.int64, device=device)
        rc = torch.zeros_like(fw)
        for j in range(k):
            cj = c[:, j : j + W]
            fw = (fw << 2) | (cj & 3)
            rc = rc | ((3 - (cj & 3)) << (2 * j))
        inv = torch.cumsum(c >= 4, dim=1)
        inv = torch.cat([torch.zeros_like(inv[:, :1]), inv], dim=1)
        good = (inv[:, k:] - inv[:, :W]) == 0
        parts.append(torch.minimum(fw, rc)[good])
        del c, fw, rc, inv, good
    return torch.cat(parts)


def count_kmers(codes: np.ndarray, k: int, min_coverage: int, device):
    """(sorted unique canonical k-mers, counts) with count >= min_coverage;
    counts saturate at 2^32 - 1."""
    keys = canonical_kmers(codes, k, device)
    uniq, cnt = torch.unique(keys, sorted=True, return_counts=True)
    del keys
    cnt = cnt.clamp(max=2**32 - 1)
    keep = cnt >= min_coverage
    return uniq[keep], cnt[keep]


class Graph:
    """De Bruijn graph over sorted canonical k-mers (SEMANTICS §3-§5)."""

    def __init__(self, kmers: torch.Tensor, counts: torch.Tensor, k: int):
        self.k = k
        self.kmers = kmers
        self.counts = counts.to(torch.int64)
        self.dev = kmers.device
        self.n = n = kmers.numel()
        self.alive = torch.ones(n, dtype=torch.bool, device=self.dev)
        self.okv = torch.stack([kmers, revcomp(kmers, k)], 1).reshape(-1)
        self.ids = torch.arange(2 * n, device=self.dev)
        self.succ = self._build_succ()

    def _build_succ(self) -> torch.Tensor:
        k, n = self.k, self.n
        succ = torch.full((2 * n, 4), -1, dtype=torch.int64, device=self.dev)
        if n == 0:
            return succ
        shifted = (self.okv << 2) & ((1 << (2 * k)) - 1)
        for b in range(4):
            ext = shifted | b
            extc = torch.minimum(ext, revcomp(ext, k))
            j = torch.searchsorted(self.kmers, extc)
            jc = j.clamp(max=n - 1)
            found = (j < n) & (self.kmers[jc] == extc)
            orient = (ext != extc).to(torch.int64)
            succ[:, b] = torch.where(found, 2 * jc + orient, -1)
        return succ

    def _state(self):
        alive_o = self.alive.repeat_interleave(2)
        tgt = self.succ
        ok = (tgt >= 0) & alive_o[tgt.clamp(min=0)] & alive_o[:, None]
        outdeg = ok.sum(1)
        usucc = torch.where(ok, tgt, -1).max(1).values
        has_next = outdeg == 1
        w = torch.where(has_next, usucc, 0)
        next_u = torch.where(has_next & (outdeg[w ^ 1] == 1), w, -1)
        nx = next_u[self.ids ^ 1]
        prev_u = torch.where(nx >= 0, nx ^ 1, -1)
        return outdeg, usucc, next_u, prev_u, alive_o

    def chains(self) -> dict:
        """Chain decomposition by pointer doubling (SEMANTICS §4)."""
        n2, ids, dev = 2 * self.n, self.ids, self.dev
        outdeg, usucc, next_u, prev_u, alive_o = self._state()
        rounds = max(1, math.ceil(math.log2(max(n2, 2))) + 1)
        p = torch.where(prev_u >= 0, prev_u, ids)
        q = p
        for _ in range(rounds):
            q = q[q]
        in_cycle = alive_o & (prev_u[q] >= 0)
        any_cycle = bool(in_cycle.any())
        prev2 = prev_u
        if any_cycle:
            # cycle head: the node of least oriented k-mer value
            mn_v, mn_i, qq = self.okv.clone(), ids.clone(), p
            for _ in range(rounds):
                cand_v, cand_i = mn_v[qq], mn_i[qq]
                take = cand_v < mn_v
                mn_v = torch.where(take, cand_v, mn_v)
                mn_i = torch.where(take, cand_i, mn_i)
                qq = qq[qq]
            prev2 = prev_u.clone()
            prev2[in_cycle & (mn_i == ids)] = -1
        p = torch.where(prev2 >= 0, prev2, ids)
        d = (prev2 >= 0).to(torch.int64)
        for _ in range(rounds):
            d = d + d[p]
            p = p[p]
        head = torch.where(alive_o, p, -1)
        dist = torch.where(alive_o, d, 0)
        is_head = alive_o & (head == ids)
        ha = head[alive_o]
        length = torch.zeros(n2, dtype=torch.int64, device=dev)
        length.scatter_reduce_(0, ha, dist[alive_o] + 1, "amax")
        cyc_head = torch.zeros(n2, dtype=torch.bool, device=dev)
        if any_cycle:
            cyc_head[head[in_cycle]] = True
        tail_of = torch.full((n2,), -1, dtype=torch.int64, device=dev)
        is_tail = alive_o & (next_u == -1)
        tail_of[head[is_tail]] = ids[is_tail]
        cov = torch.zeros(n2, dtype=torch.int64, device=dev)
        cov.index_add_(0, ha, self.counts[ids[alive_o] >> 1])
        twin_okv = torch.zeros(n2, dtype=torch.int64, device=dev)
        ok_t = is_head & ~cyc_head & (tail_of >= 0)
        twin_okv[ok_t] = self.okv[tail_of[ok_t] ^ 1]
        if any_cycle:
            tw = torch.full((n2,), _I64_MAX, dtype=torch.int64, device=dev)
            tw.scatter_reduce_(0, head[in_cycle], self.okv[ids[in_cycle] ^ 1],
                               "amin")
            sel = is_head & cyc_head
            twin_okv[sel] = tw[sel]
        return dict(outdeg=outdeg, usucc=usucc, next_u=next_u, head=head,
                    dist=dist, is_head=is_head, length=length,
                    tail_of=tail_of, cov=cov, twin_okv=twin_okv,
                    cyc_head=cyc_head, alive_o=alive_o)

    def _kill_heads(self, st, doomed: torch.Tensor) -> None:
        head = st["head"]
        node = st["alive_o"] & (head >= 0) & doomed[head.clamp(min=0)]
        self.alive[self.ids[node] >> 1] = False

    def _tail_outdeg_is(self, st, value: int) -> torch.Tensor:
        tails = st["tail_of"]
        return (tails >= 0) & (st["outdeg"][tails.clamp(min=0)] == value)

    def clip_tips(self, tip_len: int) -> bool:
        st = self.chains()
        cand = st["is_head"] & ~st["cyc_head"] & (st["length"] <= tip_len)
        if not bool(cand.any()):
            return False
        start_open = st["outdeg"][self.ids ^ 1] == 0
        end_open = self._tail_outdeg_is(st, 0)
        doomed = cand & (start_open != end_open)
        if not bool(doomed.any()):
            return False
        self._kill_heads(st, doomed)
        return True

    def pop_bubbles(self, bubble_len: int, control: bool = False) -> bool:
        st = self.chains()
        ids, okv = self.ids, self.okv
        outdeg, usucc = st["outdeg"], st["usucc"]
        cand = (st["is_head"] & ~st["cyc_head"]
                & (st["length"] <= bubble_len) & (outdeg[ids ^ 1] == 1)
                & self._tail_outdeg_is(st, 1))
        hs = ids[cand]
        if hs.numel() < 2:
            return False
        p = usucc[hs ^ 1] ^ 1
        s = usucc[st["tail_of"][hs]]
        proc = (okv[p] < okv[s ^ 1]) | ((okv[p] == okv[s ^ 1])
                                         & (okv[s] <= okv[p ^ 1]))
        selfrc = p == (s ^ 1)
        primary = okv[hs] <= st["twin_okv"][hs]
        keep = proc & (~selfrc | primary)
        hs, p, s = hs[keep], p[keep], s[keep]
        if hs.numel() < 2:
            return False
        cov = st["cov"][hs]
        # group by (p, s); within a group by (-cov, okv[head]): first kept
        o = torch.sort(okv[hs], stable=True).indices
        if not control:
            o = o[torch.sort(-cov[o], stable=True).indices]
        o = o[torch.sort(s[o], stable=True).indices]
        o = o[torch.sort(p[o], stable=True).indices]
        hs, p, s = hs[o], p[o], s[o]
        new_grp = torch.ones(hs.numel(), dtype=torch.bool, device=self.dev)
        new_grp[1:] = (p[1:] != p[:-1]) | (s[1:] != s[:-1])
        grp = torch.cumsum(new_grp, 0) - 1
        in_bubble = torch.bincount(grp)[grp] >= 2
        doomed_list = hs[in_bubble & ~new_grp]
        if doomed_list.numel() == 0:
            return False
        doomed = torch.zeros(2 * self.n, dtype=torch.bool, device=self.dev)
        doomed[doomed_list] = True
        self._kill_heads(st, doomed)
        return True

    def contigs(self) -> list[str]:
        """Primary chains as canonical contig strings (SEMANTICS §6)."""
        st = self.chains()
        ids, okv, k = self.ids, self.okv, self.k
        head = st["head"]
        primary = st["is_head"] & (okv <= st["twin_okv"])
        sel = st["alive_o"] & (head >= 0) & primary[head.clamp(min=0)]
        if not bool(sel.any()):
            return []
        vh, vd, vid = head[sel], st["dist"][sel], ids[sel]
        order = torch.sort(vh * (2 * self.n) + vd).indices
        vh, vid = vh[order], vid[order]
        first = torch.ones(vh.numel(), dtype=torch.bool, device=self.dev)
        first[1:] = vh[1:] != vh[:-1]
        starts = torch.nonzero(first).flatten()
        m = torch.diff(starts, append=torch.tensor([vh.numel()],
                                                   device=self.dev))
        lens = m + (k - 1)
        off = torch.cumsum(lens, 0) - lens
        # k bases of each head k-mer, then the last base of every later node
        shifts = 2 * torch.arange(k - 1, -1, -1, device=self.dev)
        head_bases = (okv[vh[starts]][:, None] >> shifts) & 3
        flat = torch.empty(int(lens.sum()), dtype=torch.int64,
                           device=self.dev)
        flat[(off[:, None] + torch.arange(k, device=self.dev)).reshape(-1)] \
            = head_bases.reshape(-1)
        run = torch.cumsum(first, 0) - 1
        rank = torch.arange(vh.numel(), device=self.dev) - starts[run]
        rest = ~first
        flat[off[run[rest]] + k - 1 + rank[rest]] = okv[vid[rest]] & 3
        text = _LUT[flat.to(torch.uint8).cpu().numpy()].tobytes()
        out = []
        for a, ln in zip(off.tolist(), lens.tolist()):
            seq = text[a : a + ln]
            rc = seq.translate(_RC)[::-1]
            out.append((seq if seq <= rc else rc).decode("ascii"))
        return out


def assemble(codes: np.ndarray, k: int, min_coverage: int = 2,
             tip_len: int | None = None, bubble_len: int | None = None,
             max_rounds: int = 64, min_contig_len: int = 0, device="cpu",
             control: bool = False) -> list[str]:
    """Code matrix -> sorted canonical contigs, per SEMANTICS.md."""
    tip_len = 2 * k if tip_len is None else tip_len
    bubble_len = 2 * k + 1 if bubble_len is None else bubble_len
    with torch.no_grad():
        kmers, counts = count_kmers(codes, k, min_coverage, device)
        g = Graph(kmers, counts, k)
        for _ in range(max_rounds):
            changed = g.clip_tips(tip_len)
            changed |= g.pop_bubbles(bubble_len, control)
            if not changed:
                break
        contigs = [c for c in g.contigs() if len(c) >= min_contig_len]
    return sorted(contigs)
