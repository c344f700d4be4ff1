"""Graph simplification: tips, bubbles, chain state (SURVEY.md §3.3).

Port of genome_tpu/graph/simplify.py: data-parallel masked passes over
static-capacity tensors. Chain decomposition is pointer doubling, tips
and bubbles are per-chain predicates plus scatter kills, and the
fixpoint loop runs on the host with changed-flags read back from the
device (SEMANTICS §5 pins). Each JAX `lax.cond` is a Python `if` on a
scalar read back from the device; each `jit` is gone.

Oriented node ids v = 2*i + s as in SEMANTICS §3; rc(v) = v ^ 1. Node-id
arrays are int32, k-mer values int64, coverage sums exact int64 (the JAX
16-bit limbs exist only to keep u32 sums exact). Ranking is plain int64
pointer doubling: the u32 (pointer, distance) packing of the TPU ruler
ranking has no purpose here.
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels.compact import compact_flagged, compact_ids
from genome_tpu_torch.kernels.keys import INT64_MAX

I32 = torch.int32
I64 = torch.int64

_WALK_M = (65536, 262144)  # candidate-buffer escalation ladder
_KILL_M = 65536   # compacted killed-node capacity; overflow -> recompute
_TAIL_M = 1 << 18  # compacted chain-tail buffer of the final state


def _ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _alive_o(alive, valid_node):
    return torch.repeat_interleave(alive & valid_node, 2)


def _set_drop(x, idx, val):
    """x with x[idx] = val, where idx == len(x) marks a dropped write (the
    JAX `.at[idx].set(val, mode="drop")` idiom)."""
    ext = torch.cat([x, x.new_empty(1)])
    ext[idx.reshape(-1).long()] = val if not torch.is_tensor(val) \
        else val.reshape(-1).to(x.dtype)
    return ext[:-1]


def _lexsort(keys):
    """Stable permutation sorting by keys[0], then keys[1], ... (successive
    stable sorts from the least significant key)."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _degrees(succ, alive_o):
    """outdeg + unique-successor per oriented node against alive mask."""
    ok = (succ >= 0) & alive_o[succ.clamp(min=0)] & alive_o[:, None]
    outdeg = ok.sum(dim=1, dtype=I32)
    usucc = torch.where(ok, succ, -1).max(dim=1).values
    return outdeg, usucc


def _pairswap(x):
    """x[i ^ 1]: the RC twin lives in the paired slot."""
    return x.reshape(-1, 2).flip(1).reshape(-1)


def _links(outdeg, usucc):
    """next/prev unique-link arrays (SEMANTICS §4)."""
    has = outdeg == 1
    w = torch.where(has, usucc, 0)
    next_u = torch.where(has & (outdeg[w ^ 1] == 1), w, -1)
    nx = _pairswap(next_u)
    prev_u = torch.where(nx >= 0, nx ^ 1, -1)
    return next_u, prev_u


def _double(prev_arr, ids, rounds: int):
    """Pointer doubling along prev links: (ancestor, distance) after
    `rounds` rounds (head and exact distance once 2^rounds covers the
    chain)."""
    p = torch.where(prev_arr >= 0, prev_arr, ids)
    d = (prev_arr >= 0).to(I32)
    for _ in range(rounds):
        d = d + d[p]
        p = p[p]
    return p, d


def _chain_state(succ, okv, counts, alive, valid_node,
                 max_len: int | None = None):
    """Chain decomposition by pointer doubling; per-oriented-node and
    per-head tensors, all [2C].

    max_len: when the caller only acts on chains of length <= max_len
    (tips/bubbles), doubling stops after ~log2(max_len) + 1 rounds: a
    truncated pointer can never mint a false head, and a longer chain's
    length stays above max_len. Cycles are broken (at their minimum-okv
    node, SEMANTICS §4) only for the full-rounds caller."""
    capacity = alive.shape[0]
    n2 = 2 * capacity
    dev = succ.device
    ids = _ids(n2, dev)
    alive_o = _alive_o(alive, valid_node)
    outdeg, usucc = _degrees(succ, alive_o)
    next_u, prev_u = _links(outdeg, usucc)

    rounds = max(1, (n2 - 1).bit_length() + 1)
    if max_len is not None:
        rounds = min(rounds, max(2, int(max_len).bit_length() + 1))
    p, d = _double(prev_u, ids, rounds)
    in_cycle = alive_o & (prev_u[p] >= 0)

    if max_len is None and bool(in_cycle.any()):
        # min-doubling carrying (okv, id) over the unbroken prev pointers
        mn_v, mn_i = okv, ids
        q = torch.where(prev_u >= 0, prev_u, ids)
        for _ in range(rounds):
            cv, ci = mn_v[q], mn_i[q]
            take = cv < mn_v
            mn_v = torch.where(take, cv, mn_v)
            mn_i = torch.where(take, ci, mn_i)
            q = q[q]
        # the window wrapped iff my 2^rounds ancestor sees the same min
        rep_break = in_cycle & (mn_i == ids) & (mn_i[q] == mn_i)
        p, d = _double(torch.where(rep_break, -1, prev_u), ids, rounds)

    head = torch.where(alive_o, p, -1)
    dist = torch.where(alive_o, d, 0)
    is_head = alive_o & (head == ids)

    seg = torch.where(alive_o, head, n2).long()
    length = torch.zeros(n2 + 1, dtype=I32, device=dev).scatter_reduce(
        0, seg, dist + 1, "amax")[:n2]
    length = torch.where(is_head, length, 0)
    cyc_head = _set_drop(torch.zeros(n2, dtype=torch.bool, device=dev),
                         torch.where(in_cycle, head, n2), True)
    is_tail = alive_o & (next_u == -1)
    tail_of = _set_drop(torch.full((n2,), -1, dtype=I32, device=dev),
                        torch.where(is_tail, head, n2), ids)
    node_counts = torch.repeat_interleave(counts, 2).to(I64)
    cov = torch.zeros(n2 + 1, dtype=I64, device=dev).index_add_(
        0, seg, node_counts)[:n2]
    # twin-head okv: okv(rc(tail)) for paths, min okv over the RC set for
    # cycles
    tail_c = tail_of.clamp(min=0)
    twin = torch.where(tail_of >= 0, okv[tail_c ^ 1], INT64_MAX)
    cyc_seg = torch.where(in_cycle, head, n2).long()
    cyc_min = torch.full((n2 + 1,), INT64_MAX, dtype=I64,
                         device=dev).scatter_reduce(
        0, cyc_seg, okv[ids ^ 1], "amin")[:n2]
    twin = torch.where(is_head & cyc_head, cyc_min, twin)
    return dict(outdeg=outdeg, usucc=usucc, next_u=next_u, head=head,
                dist=dist, is_head=is_head, length=length, cyc_head=cyc_head,
                tail_of=tail_of, cov=cov, twin=twin, alive_o=alive_o)


def _kill_heads(alive, st, doomed_heads):
    """Kill every canonical node whose chain head is doomed."""
    head = st["head"]
    node_doomed = (st["alive_o"] & (head >= 0)
                   & doomed_heads[head.clamp(min=0)])
    return alive & ~node_doomed.reshape(-1, 2).any(dim=1)


def clip_tips_pass_dense(succ, okv, counts, alive, valid_node, tip_len,
                         max_len: int | None = None):
    """One tip-clipping pass, dense form (SEMANTICS §5): the fallback when
    the walk pass's candidate buffer overflows. Returns (alive, changed)."""
    st = _chain_state(succ, okv, counts, alive, valid_node, max_len)
    ids = _ids(succ.shape[0], succ.device)
    cand = st["is_head"] & ~st["cyc_head"] & (st["length"] <= tip_len)
    start_open = st["outdeg"][ids ^ 1] == 0  # indeg(head) == 0
    tails = st["tail_of"]
    end_open = (tails >= 0) & (st["outdeg"][tails.clamp(min=0)] == 0)
    doomed = cand & (start_open != end_open)
    return _kill_heads(alive, st, doomed), doomed.any()


def _bubble_doomed(p, s, okv, tail, h, cand, cov):
    """Shared bubble predicate: keep the first member of each (pred,
    succ) group ordered by (coverage desc, okv(head) asc); the rest are
    doomed. Returns doomed per row."""
    n2 = okv.shape[0]
    proc = (okv[p] < okv[s ^ 1]) | ((okv[p] == okv[s ^ 1])
                                    & (okv[s] <= okv[p ^ 1]))
    selfrc = p == (s ^ 1)
    twin = torch.where(tail >= 0, okv[tail.clamp(0, n2 - 1) ^ 1], INT64_MAX)
    primary = okv[h] <= twin
    keep = cand & proc & (~selfrc | primary)
    ps = (torch.where(keep, p, n2).to(I64) << 32) | torch.where(keep, s, n2)
    order = _lexsort([ps, -cov, okv[h]])
    ps_s = ps[order]
    same_prev = torch.zeros_like(keep)
    same_prev[1:] = ps_s[1:] == ps_s[:-1]
    doomed_sorted = ((ps_s >> 32) < n2) & same_prev
    rows = keep.shape[0]
    return _set_drop(torch.zeros_like(keep),
                     torch.where(doomed_sorted, order, rows), True)


def pop_bubbles_pass_dense(succ, okv, counts, alive, valid_node, bubble_len,
                           max_len: int | None = None):
    """One bubble-popping pass, dense form (overflow fallback). Returns
    (alive, changed)."""
    st = _chain_state(succ, okv, counts, alive, valid_node, max_len)
    ids = _ids(succ.shape[0], succ.device)
    outdeg, usucc = st["outdeg"], st["usucc"]
    tails = st["tail_of"]
    tail_c = tails.clamp(min=0)
    cand = (st["is_head"] & ~st["cyc_head"] & (st["length"] <= bubble_len)
            & (outdeg[ids ^ 1] == 1) & (tails >= 0) & (outdeg[tail_c] == 1))
    p = torch.where(cand, usucc[ids ^ 1] ^ 1, 0)  # unique pred of head
    s = torch.where(cand, usucc[tail_c], 0)       # unique succ of tail
    doomed = _bubble_doomed(p, s, okv, tails, ids, cand, st["cov"])
    return _kill_heads(alive, st, doomed), doomed.any()


# ---------------------------------------------------------------------------
# Walk-based tip/bubble passes: compact the chain heads to an M-slot buffer
# (the stream compactor), walk <= L link steps forward on M-sized tensors,
# evaluate the same SEMANTICS §5 predicates, kill doomed chains along the
# recorded paths. If heads exceed M the caller escalates M and finally
# falls back to the dense pass (partial walk results are never used).
# ---------------------------------------------------------------------------


def _walk_stats(next_u, counts, heads, n_heads, L: int, want_cov: bool):
    """Walk <= L link steps forward from each compacted head. length
    saturates at L+1 (longer chains keep tail == -1)."""
    M = heads.shape[0]
    n2 = next_u.shape[0]
    capacity = counts.shape[0]
    real = torch.arange(M, device=heads.device) < n_heads
    cur = torch.where(real, heads, 0)
    path = [torch.where(real, cur, -1)]
    length = real.to(I32)
    cov = None
    if want_cov:
        cov = torch.where(real, counts[(cur >> 1).clamp(0, capacity - 1)],
                          0).to(I64)
    tail = torch.full((M,), -1, dtype=I64, device=heads.device)
    done = ~real
    for _ in range(L):
        nx = torch.where(done, -1, next_u[cur.clamp(0, n2 - 1)])
        tail = torch.where(~done & (nx < 0), cur, tail)
        done = done | (nx < 0)
        ext = nx >= 0
        cur = torch.where(ext, nx, cur)
        path.append(torch.where(ext, cur, -1))
        if want_cov:
            cov = cov + torch.where(
                ext, counts[(cur >> 1).clamp(0, capacity - 1)], 0)
        length = length + ext.to(I32)
    # tail of a chain of length exactly L (its probe was consumed)
    nx = torch.where(done, -1, next_u[cur.clamp(0, n2 - 1)])
    tail = torch.where(~done & (nx < 0), cur, tail)
    return dict(real=real, length=length, tail=tail,
                path=torch.stack(path, dim=0), cov=cov)


def _kill_paths(alive, path, doomed_m):
    """Kill every canonical node on a doomed head's recorded path."""
    kill = doomed_m[None, :] & (path >= 0)
    return _set_drop(alive, torch.where(kill, path >> 1, alive.shape[0]),
                     False)


def _tips_body(alive, valid_node, outdeg, next_u, prev_u, counts, tip_len,
               L: int, M: int):
    n2 = next_u.shape[0]
    is_head = _alive_o(alive, valid_node) & (prev_u < 0)
    heads, n_heads, ovf = compact_ids(is_head, M, site="tips")
    st = _walk_stats(next_u, counts, heads, n_heads, L, want_cov=False)
    h = torch.where(st["real"], heads, 0)
    tail = st["tail"]
    cand = st["real"] & (st["length"] <= tip_len)
    start_open = outdeg[h ^ 1] == 0
    end_open = (tail >= 0) & (outdeg[tail.clamp(0, n2 - 1)] == 0)
    doomed = cand & (start_open != end_open)
    return st["path"], doomed, ovf


def _bubbles_body(alive, valid_node, outdeg, usucc, next_u, prev_u, okv,
                  counts, bubble_len, L: int, M: int):
    n2 = next_u.shape[0]
    is_head = _alive_o(alive, valid_node) & (prev_u < 0)
    heads, n_heads, ovf = compact_ids(is_head, M, site="bubbles")
    st = _walk_stats(next_u, counts, heads, n_heads, L, want_cov=True)
    h = torch.where(st["real"], heads, 0)
    tail = st["tail"]
    tailc = tail.clamp(0, n2 - 1)
    cand = (st["real"] & (st["length"] <= bubble_len)
            & (outdeg[h ^ 1] == 1) & (tail >= 0) & (outdeg[tailc] == 1))
    p = torch.where(cand, usucc[h ^ 1] ^ 1, 0)
    s = torch.where(cand, usucc[tailc], 0)
    # candidates enter in ascending head-id order (the compaction keeps
    # stream order), as in the dense pass
    doomed = _bubble_doomed(p, s, okv, tail, h, cand, st["cov"])
    return st["path"], doomed, ovf


def _compact_vals(flags, vals, M: int):
    """Values at flagged positions, compacted to M slots (in order)."""
    (v,), _, total, ovf = compact_flagged(flags, (vals,), M, site="kills")
    return v, total, ovf


def _update_degrees(succ, alive2, valid_node, path, doomed_m, outdeg, usucc,
                    next_u, Mk: int):
    """(outdeg, usucc, next_u, prev_u) for alive2, given their values for
    the pre-kill alive and the pass's kill set (doomed walk paths).
    Exactly the dense recompute; kovf when kills exceed Mk (results then
    unusable), lovf when the link-affected set exceeds its buffer (links
    unusable, degrees still good). Rule and proof: the JAX reference,
    graph/simplify.py::_update_degrees."""
    n2 = succ.shape[0]
    dev = succ.device
    kill = doomed_m[None, :] & (path >= 0)
    canon = torch.where(kill, path >> 1, 0).reshape(-1)
    kc, nk, kovf = _compact_vals(kill.reshape(-1).contiguous(), canon, Mk)
    real = torch.arange(Mk, device=dev) < torch.clamp(nk, max=Mk)
    # dedup: a self-RC chain's path can visit both orientations of one
    # canonical node, whose lost edges must be subtracted once
    kc_s = torch.sort(torch.where(real, kc, n2)).values
    first = torch.ones_like(real)
    first[1:] = kc_s[1:] != kc_s[:-1]
    real = first & (kc_s != n2)
    kc_ = torch.where(real, kc_s, 0)
    alive_o2 = _alive_o(alive2, valid_node)
    # all out-edges of both orientations of each killed node; each edge
    # (rc(w) -> killed) loses rc(w) one outdegree
    w = torch.cat([succ[(2 * kc_).clamp(0, n2 - 1)],
                   succ[(2 * kc_ + 1).clamp(0, n2 - 1)]], dim=1)  # [Mk, 8]
    wc = w.clamp(0, n2 - 1)
    wv = (w >= 0) & real[:, None] & alive_o2[wc]
    tgt = torch.where(wv, wc ^ 1, n2).long()
    dead = torch.where(real[:, None],
                       2 * kc_[:, None] + torch.arange(2, device=dev), n2)
    outdeg2 = torch.cat([outdeg, outdeg.new_zeros(1)])
    outdeg2.index_add_(0, tgt.reshape(-1), -wv.reshape(-1).to(I32))
    outdeg2 = _set_drop(outdeg2[:n2], dead, 0)
    # usucc changed exactly on the affected in-neighbors: recompute there
    su = succ[tgt.clamp(0, n2 - 1)]  # [Mk, 8, 4]
    at_ = (su >= 0) & alive_o2[su.clamp(0, n2 - 1)]
    new_us = torch.where(at_, su, -1).max(dim=2).values
    usucc2 = _set_drop(_set_drop(usucc, tgt, new_us), dead, -1)

    # incremental next/prev links over A + rc(succ(A))
    M2 = 2 * Mk
    aff0 = torch.cat([tgt.reshape(-1), dead.reshape(-1)])
    ac, n_aff, lovf = _compact_vals(aff0 < n2, aff0, M2)
    areal = torch.arange(M2, device=dev) < torch.clamp(n_aff, max=M2)
    acc = torch.where(areal, ac, 0).clamp(0, n2 - 1)
    sa = succ[acc]  # [M2, 4]
    cand = torch.where((sa >= 0) & areal[:, None], sa ^ 1, n2)
    aff = torch.cat([torch.where(areal, acc, n2), cand.reshape(-1)])
    affc = aff.clamp(0, n2 - 1)
    wl = usucc2[affc]
    okl = ((outdeg2[affc] == 1) & (wl >= 0)
           & (outdeg2[(wl ^ 1).clamp(0, n2 - 1)] == 1))
    next2 = _set_drop(next_u, aff, torch.where(okl, wl, -1))
    nx = _pairswap(next2)
    prev2 = torch.where(nx >= 0, nx ^ 1, -1)
    return outdeg2, usucc2, next2, prev2, kovf, lovf


def run_pass_inc(kind: str, succ, okv, counts, alive, valid_node,
                 threshold: int, max_len: int, deg, links=None,
                 walk_m=_WALK_M):
    """One tip/bubble pass with carried degrees AND links.

    deg: (outdeg, usucc) matching `alive`, or None (computed here).
    links: (next_u, prev_u) matching `alive`, or None (computed here).
    walk_m: candidate-buffer ladder (overridable so tests force every
    rung and the dense fallback).
    Returns (alive2, changed, links_prekill_or_None, deg2_or_None,
    links2_or_None): the pre-kill links are valid for the post state only
    when changed is False; deg2/links2 match alive2 unless their update
    buffers overflowed or the dense fallback ran (then None)."""
    if kind not in ("tips", "bubbles"):
        raise ValueError(f"unknown pass {kind!r}")
    if deg is None:
        deg = _degrees(succ, _alive_o(alive, valid_node))
    if links is None:
        links = _links(deg[0], deg[1])
    outdeg, usucc = deg
    next_u, prev_u = links
    L = int(max_len)
    for M in walk_m:
        if kind == "tips":
            path, doomed, ovf = _tips_body(alive, valid_node, outdeg, next_u,
                                           prev_u, counts, threshold, L, M)
        else:
            path, doomed, ovf = _bubbles_body(
                alive, valid_node, outdeg, usucc, next_u, prev_u, okv,
                counts, threshold, L, M)
        if bool(ovf):
            continue
        alive2 = _kill_paths(alive, path, doomed)
        od2, us2, nx2, pv2, kovf, lovf = _update_degrees(
            succ, alive2, valid_node, path, doomed, outdeg, usucc, next_u,
            _KILL_M)
        changed = doomed.any()
        kovf, lovf = torch.stack([kovf, lovf]).tolist()
        if kovf:
            return alive2, changed, links, None, None
        return alive2, changed, links, (od2, us2), \
            None if lovf else (nx2, pv2)
    dense = clip_tips_pass_dense if kind == "tips" else pop_bubbles_pass_dense
    a2, ch = dense(succ, okv, counts, alive, valid_node, threshold, max_len)
    return a2, ch, None, None, None


# ---------------------------------------------------------------------------
# Final chain state for emission.
# ---------------------------------------------------------------------------


def _rank(prev_u):
    """(head, dist, ok) by plain pointer doubling over prev links; ok is
    False iff a cycle survives (its members never reach a head)."""
    n2 = prev_u.shape[0]
    ids = _ids(n2, prev_u.device)
    head, dist = _double(prev_u, ids, max(1, (n2 - 1).bit_length() + 1))
    ok = ~(prev_u[head] >= 0).any()
    return head, dist, ok


def _final_chain_state_links(succ, okv, counts, alive, valid_node, next_u,
                             prev_u):
    """final_chain_state with the link tensors precomputed (handed over
    from the fixpoint loop's last no-change pass)."""
    n2 = succ.shape[0]
    dev = succ.device
    ids = _ids(n2, dev)
    alive_o = _alive_o(alive, valid_node)
    head_r, dist_r, ok = _rank(prev_u)
    if bool(ok):
        head = torch.where(alive_o, head_r, -1)
        dist = torch.where(alive_o, dist_r, 0)
        is_head = alive_o & (head == ids)
        is_tail = alive_o & (next_u == -1)
        # twin values are needed only at the heads, and chains << nodes
        # after simplification: compact the tails, scatter okv(rc(tail))
        # to each tail's head
        tails, n_t, tovf = compact_ids(is_tail, _TAIL_M, site="tails")
        if bool(tovf):
            tail_of = _set_drop(torch.full((n2,), -1, dtype=I32, device=dev),
                                torch.where(is_tail, head, n2), ids)
            tc = tail_of.clamp(min=0)
            twin = torch.where(tail_of >= 0, okv[tc ^ 1], INT64_MAX)
        else:
            treal = torch.arange(_TAIL_M, device=dev) < n_t
            tc = torch.where(treal, tails, 0).clamp(0, n2 - 1)
            twin = _set_drop(
                torch.full((n2,), INT64_MAX, dtype=I64, device=dev),
                torch.where(treal, head[tc], n2), okv[tc ^ 1])
        primary = is_head & (okv <= twin)
    else:
        st = _chain_state(succ, okv, counts, alive, valid_node)
        head, dist = st["head"], st["dist"]
        primary = st["is_head"] & (okv <= st["twin"])
    return dict(head=head, dist=dist, primary=primary, alive_o=alive_o)


def final_chain_state(succ, okv, counts, alive, valid_node, links=None):
    """Chain state + primary mask for contig emission (SEMANTICS §6).

    Fast path: pointer-doubling ranks + the tail twins the primary pin
    needs; the dense path (exact cycle breaking) when any cycle survives.
    links: optional (next_u, prev_u) computed on exactly this alive mask."""
    if links is None:
        links = _links(*_degrees(succ, _alive_o(alive, valid_node)))
    return _final_chain_state_links(succ, okv, counts, alive, valid_node,
                                    links[0], links[1])
