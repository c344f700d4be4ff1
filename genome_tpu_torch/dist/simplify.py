"""Sharded graph simplification: the tip and bubble passes by distributed
pointer doubling (port of genome_tpu/dist/simplify.py, its passes and
host loop).

The oriented id space is sharded over the group (global id v = rank *
2 * local_capacity + local, as dist/build.py numbers it), so every
access across ranks is an exchange built on route_buckets:

- remote_gather: requests routed to the owner rank (all_to_all #1),
  answered there, the answers routed back (all_to_all #2) into the
  requesting slots;
- seg_route: per-head aggregates, one routing of (head, payload...)
  records to the head's owner, pre-combined on the sender, then plain
  segment reductions at the owner;
- the bubble (p, s) groups: records routed by a hash of (p, s) so that
  each group lands whole on one rank, sorted there, and the losers routed
  to their owners as kill messages.

Every per-rank function is the body of a JAX shard_map: each rank of the
group calls it with its own tensors, in the same order. The exchanges
carry JAX's widths: int32 columns for ids, lengths, flags and counts,
two int32 columns (the low and high words) for an int64 okv or coverage
sum, so a ledger entry's bytes equal JAX's. Capacities are fixed per
call; an overflow is agreed across the ranks and the host loop retries
from the start with doubled slack (the ladder), or the caller falls back
to the replicated passes. Semantics are those of graph/simplify.py
(SEMANTICS §5): every pin is k-mer-value based.

The sharded final state for emission stays sharded too: the exact one
(make_sharded_final: the uncapped chain state, cycles broken at their
minimum-okv node by min-doubling) and the ruler-ranking fast one
(make_sharded_final_fast: early-exit doubling frozen at every
RULER_STRIDE-th id, then doubling over the rulers alone), tried first by
final_state_sharded's ladder.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import count
from genome_tpu_torch.dist.count import EMPTY32, route_buckets
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import all_any_each, all_to_all_rows
from genome_tpu_torch.graph.simplify import _lexsort, _pairswap, _set_drop
from genome_tpu_torch.kernels.compact import compact_flagged, compact_ids
from genome_tpu_torch.kernels.keys import INT64_MAX, fmix32, mul32

I32 = torch.int32
I64 = torch.int64

# per-rank compaction buffer for a pass's killed canonicals (the
# incremental degree/link update, update_deg): kills beyond it fall back
# to a fresh degree recompute. Read when the passes are built, so a
# test may override it.
_KILL_MD = 4096

# rungs of a slack ladder (1.35, doubled each rung): the passes' before
# the caller falls back to the replicated passes, and each of the final
# state's two (fast, then exact)
_SLACK_RUNGS = 3

# ruler spacing of the fast final state: ids that are multiples of it
# are rulers (a power of two; the gap tail ~ STRIDE * ln(ids))
RULER_STRIDE = 16

# the fast final's phase-1 round cap: it covers ruler gaps up to
# 2^(cap - 1); a longer gap, or a cycle without a ruler, exits
# unconverged (ok = False) into the exact final. P(gap > 4096) ~
# ids * (15/16)^4096 ~ 0.
_P1_CAP = 13


def _bub_mc(cl2: int, slack: float) -> int:
    """Bubble-candidate compaction buffer per rank: candidates are chain
    heads passing the bubble filter (<< cl2); it scales with the ladder's
    slack, so an overflow retry doubles it with the route capacities.
    Read when the passes are built, so a test may override it."""
    return min(cl2, max(4096, int(65536 * slack / 1.35)))


def _cap_for(m: int, num_shards: int, slack: float = 1.35) -> int:
    """Per-owner bucket capacity for m hash-balanced requests."""
    return max(64, int(slack * m / num_shards) + 64)


def _cols(vals) -> list:
    """The int32 columns that carry `vals` on the wire: an int32 tensor
    is one, an int64 tensor two (its low and high words)."""
    cols = []
    for v in vals:
        if v.dtype == I64:
            w = v.contiguous().view(I32).reshape(-1, 2)
            cols += [w[:, 0], w[:, 1]]
        else:
            cols.append(v)
    return cols


def _uncols(cols, dtypes) -> list:
    """Inverse of _cols: the values of `dtypes` from their columns."""
    it = iter(cols)
    out = []
    for dt in dtypes:
        if dt == I64:
            lo, hi = next(it), next(it)
            out.append(torch.stack([lo, hi], 1).view(I64).reshape(-1))
        else:
            out.append(next(it))
    return out


def _run_heads(skey):
    """True where a sorted key differs from the one before it."""
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    return first


def _back_multi(cols, num_shards: int, cap: int, group, ledger):
    """Return response columns along the request buckets' layout: one
    all_to_all for all of them (stacked column-wise)."""
    stacked = torch.cat([c.reshape(num_shards, cap) for c in cols], dim=1)
    out = all_to_all_rows(stacked, group)
    if ledger is not None:
        ledger.record_a2a(num_shards, stacked.numel() * stacked.element_size())
    return [out[:, j * cap : (j + 1) * cap].reshape(-1)
            for j in range(len(cols))]


def make_ops(group, width: int, ledger: ExchangeLedger | None = None):
    """The sharded primitives over an id space of `width` ids a rank
    (2 * local_capacity oriented ids, or local_capacity canonical ones)."""
    S, me = dist.get_world_size(group), dist.get_rank(group)
    if S * width > EMPTY32:
        # ids ride as int32 words, with EMPTY32 above every one of them
        raise ValueError(f"{S} ranks of {width} ids pass the int32 id "
                         f"space ({EMPTY32})")

    def remote_gather(vals, idx, valid, cap, defaults):
        """vals[j][idx[i]] over the sharded global id space.

        vals: this rank's [width] int32/int64 slices of global arrays;
        idx: [M] int32 global ids; valid: [M] mask. Returns (outs, ovf):
        outs[j][i] is the global vals[j][idx[i]] where valid, else
        defaults[j] (a scalar or an [M] tensor). Owner-local requests are
        answered without the exchange. Remote ones are deduplicated by a
        stable sort of (idx, slot): only run heads are routed, the
        answers are broadcast down the runs and put back through the
        inverse permutation, and every answer rides one all_to_all."""
        m, dev = idx.shape[0], idx.device
        own = torch.where(valid, idx // width, S)
        is_mine = valid & (own == me)
        loc_self = (idx - me * width).clamp(0, width - 1)
        remote = valid & (own != me)
        skey, sslot = torch.sort(torch.where(remote, idx, EMPTY32),
                                 stable=True)
        first = _run_heads(skey)
        uniq = first & (skey != EMPTY32)
        own_u = torch.where(uniq, skey // width, S)
        (ridx,), send_pos, ovf = route_buckets((skey,), own_u, S, cap, group,
                                               ledger)
        present = ridx != EMPTY32
        loc = (ridx - me * width).clamp(0, width - 1)
        pos = torch.arange(m, device=dev)
        # each sorted slot's run head (runs are contiguous): the heads'
        # positions by run id, read at each slot's run id (JAX's cummax
        # of the head positions; torch's cummax is a slow generic scan
        # on the card)
        rid = torch.cumsum(first, 0) - 1
        head_pos = _set_drop(torch.empty_like(pos), torch.where(first, rid, m),
                             pos)
        inv = torch.empty_like(pos)
        inv[sslot] = pos
        src = head_pos[rid][inv]  # slot i's run head, as a sorted position
        dtypes = [v.dtype for v in vals]
        gots = _uncols(_back_multi(
            _cols([torch.where(present, v[loc], 0) for v in vals]), S, cap,
            group, ledger), dtypes)
        sp = send_pos.clamp(min=0)
        ok_head = uniq & (send_pos >= 0)
        answered = valid & (is_mine | (remote & ok_head[src]))
        outs = []
        for v, d, got in zip(vals, defaults, gots):
            o = torch.where(ok_head, got[sp], 0)[src]
            o = torch.where(is_mine, v[loc_self], o)
            outs.append(torch.where(answered, o, d))
        return outs, ovf

    def seg_route(vals, ops, seg, valid, cap):
        """Route (seg, vals...) records to seg's owner, pre-combined.

        All of a rank's records for one segment are reduced first (ops[j]
        "max", "sum" or "min") so that at most one record a (sender,
        segment) rides the exchange: without it every node of a chain
        routes to its head's owner and one long chain overflows any
        capacity. Returns (local segment [S * cap] int32, width where
        empty; the routed values; present mask; ovf)."""
        m = seg.shape[0]
        skey, order = torch.sort(torch.where(valid, seg, EMPTY32),
                                 stable=True)
        first = _run_heads(skey)
        rid = torch.cumsum(first, 0) - 1
        # the records of no segment (one run at the end) are dropped
        tgt = torch.where(skey != EMPTY32, rid, m)
        combined = [_seg_reduce(v[order], tgt, m, op, 0)[rid]
                    for v, op in zip(vals, ops)]
        uniq = first & (skey != EMPTY32)
        own_u = torch.where(uniq, skey // width, S)
        routed, _, ovf = route_buckets(
            tuple(_cols([skey] + combined)), own_u, S, cap, group, ledger)
        rseg = routed[0]
        present = rseg != EMPTY32
        lseg = torch.where(present, (rseg - me * width).clamp(0, width - 1),
                           width)
        return (lseg, _uncols(routed[1:], [v.dtype for v in vals]), present,
                ovf)

    return remote_gather, seg_route


def _paired(v):
    """[cl2] -> ([cl], [cl]): the even and odd slots, for the gathers in
    the canonical id space."""
    return v[0::2], v[1::2]


def _seg_reduce(vals, seg, n: int, op: str, init):
    """Per-segment reduction ("sum", "max" or "min") of vals into n slots,
    init where a slot has no record; seg >= n is dropped. Each dropped
    record goes to a slot of its own: on the card one shared drop slot
    would serialise millions of atomics."""
    m = seg.shape[0]
    tgt = torch.where(seg < n, seg, n + torch.arange(m, device=seg.device))
    out = torch.full((n + m,), init, dtype=vals.dtype, device=vals.device)
    if op == "sum":
        out.index_add_(0, tgt, vals)
    else:
        out.scatter_reduce_(0, tgt, vals, "a" + op, include_self=False)
    return out[:n]


def _degrees_links(succ, alive_o, remote_gather, gcap4: int, gcap1: int):
    """Sharded (outdeg, usucc, next_u, prev_u) from scratch: the alive
    gather over the 4 * cl2 edge targets and the deg-at-twin gather, the
    two exchanges the carried-degree passes do not pay a pass."""
    tgt = succ.reshape(-1)
    (tgt_alive,), o1 = remote_gather(
        (alive_o.to(I32),), tgt.clamp(min=0), tgt >= 0, gcap4, (0,))
    ok = ((tgt >= 0) & (tgt_alive != 0)).reshape(-1, 4) & alive_o[:, None]
    outdeg = ok.sum(dim=1, dtype=I32)
    usucc = torch.where(ok, succ, -1).max(dim=1).values
    has = outdeg == 1
    w = torch.where(has, usucc, 0)
    (deg_w1,), o2 = remote_gather((outdeg,), w ^ 1, has, gcap1, (0,))
    next_u = torch.where(has & (deg_w1 == 1), w, -1)
    nx = _pairswap(next_u)
    prev_u = torch.where(nx >= 0, nx ^ 1, -1)
    return outdeg, usucc, next_u, prev_u, o1 | o2


def make_sharded_simplify(group, local_capacity: int, slack: float = 1.35,
                          tip_max_len: int | None = None,
                          bubble_max_len: int | None = None,
                          ledger: ExchangeLedger | None = None):
    """The sharded passes and the exact final state at one rung of the
    slack ladder: (tips, bubbles, final, degrees), per-rank functions.

    Each takes this rank's tensors: succ [cl2, 4] int32 (global oriented
    ids), okv [cl2] int64, counts [cl] int32, alive [cl] bool and n_loc,
    the rank's valid node count. degrees(succ, alive, n_loc) returns
    ((outdeg, usucc, next_u, prev_u), ovf); tips(succ, okv, counts, alive,
    n_loc, tip_len, deg) and bubbles(..., bubble_len, deg) return (alive2,
    changed, ovf, deg2, kovf): deg2 matches alive2 unless kovf (a buffer
    of the incremental update overflowed: recompute it). Flags are 0-dim
    tensors of this rank alone; the caller agrees them.

    slack: the route capacities' multiplier. tip_max_len, bubble_max_len:
    the pass thresholds. Doubling stops after ~log2(max_len) rounds, as
    in the local passes, and the cycle machinery is skipped: the
    candidates' ~cyc_head guard needs only the prev[p] gather.
    final(succ, okv, counts, alive, n_loc) runs every doubling round and
    the cycle machinery: see make_sharded_final.
    """
    S, me = dist.get_world_size(group), dist.get_rank(group)
    cl = local_capacity
    cl2 = 2 * cl
    rounds = max(1, (S * cl2 - 1).bit_length() + 1)
    gcap1 = _cap_for(cl2, S, slack)
    gcap4 = _cap_for(4 * cl2, S, slack)
    kill_md = _KILL_MD
    dk_cap = _cap_for(8 * kill_md, S, slack)
    da_cap = _cap_for(4 * S * dk_cap, S, slack)
    bub_mc = _bub_mc(cl2, slack)
    caps = (S, cl, gcap1, gcap4, kill_md, dk_cap, da_cap, bub_mc,
            tip_max_len, bubble_max_len)  # the ledger's program key
    rg, seg_route = make_ops(group, cl2, ledger)
    rg_canon, _ = make_ops(group, cl, ledger)

    def _program(name):
        if ledger is not None:
            ledger.program(name, caps)

    def _setup(alive, n_loc, dev):
        valid_node = torch.arange(cl, device=dev) < n_loc
        ids_g = me * cl2 + torch.arange(cl2, dtype=I32, device=dev)
        return valid_node, ids_g, torch.repeat_interleave(alive & valid_node, 2)

    def double(prev, ids_g, rnds, ovf):
        """Head + distance doubling over the prev links (remote p[p];
        self-pointers are fixpoints and are not requested)."""
        p = torch.where(prev >= 0, prev, ids_g)
        d = (prev >= 0).to(I32)
        for _ in range(rnds):
            (p2, dp), o = rg((p, d), p, p != ids_g, gcap1, (p, 0))
            p, d, ovf = p2, d + dp, ovf | o
        return p, d, ovf

    def chain_state(okv, counts, alive_o, ids_g, max_len, deg):
        """Chain heads, distances and per-head aggregates. max_len caps
        the doubling at ~log2(max_len) rounds (the passes); None runs
        every round and breaks the cycles (the exact final state)."""
        dev = okv.device
        outdeg, usucc, next_u, prev_u = deg
        rnds = rounds if max_len is None else min(
            rounds, max(2, int(max_len).bit_length() + 1))
        p, d, ovf = double(prev_u, ids_g, rnds,
                           torch.zeros((), dtype=torch.bool, device=dev))
        # p == self does NOT imply prev_u[self] < 0: a self-loop node
        # (a homopolymer run >= k+1) has prev_u[v] = v. The gather takes
        # self-pointers too (answered locally), or 1-cycles escape the
        # cycle test and emission diverges from the single-device path.
        (prev_p,), o = rg((prev_u,), p, alive_o, gcap1, (-1,))
        ovf |= o
        in_cycle = alive_o & (prev_p >= 0)
        if max_len is None:
            # each cycle's representative: its minimum (okv, id), by
            # min-doubling over the unbroken links (a gather at self
            # would return the own carry: not requested). okv is a
            # non-negative int64, so `<` orders it as JAX's (hi, lo)
            # pair compare does.
            mokv, mid, q = okv, ids_g, torch.where(prev_u >= 0, prev_u,
                                                   ids_g)
            for _ in range(rounds):
                (cokv, cid, q2), o = rg((mokv, mid, q), q, q != ids_g,
                                        gcap1, (mokv, mid, q))
                take = cokv < mokv
                mokv = torch.where(take, cokv, mokv)
                mid = torch.where(take, cid, mid)
                q, ovf = q2, ovf | o
            # head and distance again, with each cycle broken at its rep
            rep_break = in_cycle & (mid == ids_g)
            p, d, ovf = double(torch.where(rep_break, -1, prev_u), ids_g,
                               rounds, ovf)
        head = torch.where(alive_o, p, -1)
        dist_ = torch.where(alive_o, d, 0)
        is_head = alive_o & (head == ids_g)

        # per-head aggregates: one routing of every payload to the head
        is_tail = alive_o & (next_u == -1)
        payloads = (
            dist_ + 1,
            torch.repeat_interleave(counts, 2).to(I64),
            in_cycle.to(I32),
            # tail id + 1, so that 0 is absent under max
            torch.where(is_tail, ids_g + 1, 0),
            torch.where(in_cycle, _pairswap(okv), INT64_MAX),
        )
        lseg, routed, present, o = seg_route(
            payloads, ("max", "sum", "max", "max", "min"), head.clamp(min=0),
            alive_o & (head >= 0), gcap1)
        ovf |= o
        r_len, r_cov, r_cyc, r_tail, r_okv = routed
        seg = lseg.long()
        length = _seg_reduce(r_len, seg, cl2, "max", 0)
        cov = _seg_reduce(r_cov, seg, cl2, "sum", 0)
        cyc_head = _seg_reduce(r_cyc, seg, cl2, "max", 0) > 0
        tail_of = _seg_reduce(r_tail, seg, cl2, "max", 0) - 1
        cyc_min = _seg_reduce(r_okv, seg, cl2, "min", INT64_MAX)

        # twin head okv: okv(rc(tail)) for paths, the cycle minimum for
        # cycles. The paired okv lives in the canonical id space (global
        # id rank * cl + local), so its gather is the canonical instance:
        # the oriented one would send every request of rank > 0 to the
        # wrong owner.
        pe, po = _paired(okv)
        (t0, t1), o = rg_canon((pe, po), tail_of.clamp(min=0) // 2,
                               tail_of >= 0, gcap1, (INT64_MAX, INT64_MAX))
        ovf |= o
        twin = torch.where(tail_of >= 0,
                           torch.where((tail_of & 1) == 1, t0, t1), INT64_MAX)
        twin = torch.where(is_head & cyc_head, cyc_min, twin)
        return dict(outdeg=outdeg, usucc=usucc, head=head, dist=dist_,
                    is_head=is_head, length=length, cyc_head=cyc_head,
                    tail_of=tail_of, cov=cov, twin=twin, alive_o=alive_o,
                    ovf=ovf)

    def kill_heads(alive, st, doomed_heads):
        """doomed_heads: [cl2] bool at the head's owner rank."""
        head = st["head"]
        (dm,), o = rg((doomed_heads.to(I32),), head.clamp(min=0),
                      st["alive_o"] & (head >= 0), gcap1, (0,))
        node_doomed = st["alive_o"] & (dm != 0)
        return alive & ~node_doomed.reshape(-1, 2).any(dim=1), o

    def update_deg(succ, alive2, valid_node, killed_c, outdeg, usucc,
                   next_u):
        """Post-kill (outdeg, usucc, next_u, prev_u): the distributed
        analog of graph/simplify.py::_update_degrees. The killed
        canonicals are compacted to kill_md slots; their edges' twins get
        routed decrements (whether the target is still alive is judged at
        its owner, so no alive exchange), and usucc and the links are
        recomputed over the affected union only (received targets, dead
        rows and their rc-successors). kovf: a buffer overflowed and the
        caller recomputes degrees from scratch (the results are then
        unusable)."""
        dev = succ.device
        alive2_o = torch.repeat_interleave(alive2 & valid_node, 2)
        kc, nk, kovf = compact_ids(killed_c, kill_md, site="dist_kills")
        real = torch.arange(kill_md, device=dev) < nk.clamp(max=kill_md)
        kcc = torch.where(real, kc, 0).clamp(0, cl - 1)
        rows = torch.cat([succ[2 * kcc], succ[2 * kcc + 1]], dim=1)  # [Mk, 8]
        wv = ((rows >= 0) & real[:, None]).reshape(-1)
        w = rows.clamp(min=0).reshape(-1)
        # decrements routed to the owner of w ^ 1 (w's owner): one summed
        # record a (sender, target)
        lseg, (rcnt,), present, o1 = seg_route(
            (torch.ones(kill_md * 8, dtype=I32, device=dev),), ("sum",),
            w ^ 1, wv, dk_cap)
        lseg_c = lseg.clamp(0, cl2 - 1)
        apply = present & alive2_o[lseg_c]
        at = torch.where(apply, lseg, cl2).long()
        od2 = outdeg - _seg_reduce(rcnt, at, cl2, "sum", 0)
        dead = torch.where(real[:, None],
                           2 * kcc[:, None] + torch.arange(2, device=dev),
                           cl2).reshape(-1)
        od2 = _set_drop(od2, dead, 0)

        # usucc at the received rows (their successors' alive set
        # changed): gather the post-kill alive of their <= 4 successors
        su = succ[lseg_c]  # [S * dk_cap, 4]
        sv = (su >= 0) & apply[:, None]
        (sa,), o2 = rg((alive2_o.to(I32),), su.clamp(min=0).reshape(-1),
                       sv.reshape(-1), da_cap, (0,))
        okm = sv & (sa.reshape(-1, 4) != 0)
        new_us = torch.where(okm, su, -1).max(dim=1).values
        us2 = _set_drop(usucc, at, torch.where(apply, new_us, -1))
        us2 = _set_drop(us2, dead, -1)

        # links over U = affected | dead | rc-successors of both (the
        # _update_degrees affected-set rule): next[v] flips only where
        # v's own (outdeg, usucc) changed or outdeg[usucc[v] ^ 1] did
        aff = torch.cat([torch.where(apply, lseg, cl2), dead.to(I32)])
        sa2 = succ[aff.clamp(0, cl2 - 1)]  # [Na, 4]
        av = (sa2 >= 0) & (aff < cl2)[:, None]
        cand = torch.where(av, sa2 ^ 1, 0).reshape(-1)
        ccap = _cap_for(cand.shape[0], S, slack)
        (rc_ids,), _, o3 = route_buckets(
            (cand,), torch.where(av.reshape(-1), cand // cl2, S), S, ccap,
            group, ledger)
        cloc = (rc_ids - me * cl2).clamp(0, cl2 - 1)
        U = torch.cat([aff, torch.where(rc_ids != EMPTY32, cloc, cl2)])
        Uc = U.clamp(0, cl2 - 1)
        uvalid = U < cl2
        wl = us2[Uc]
        ucap = _cap_for(U.shape[0], S, slack)
        (degw,), o4 = rg((od2,), wl.clamp(min=0) ^ 1, uvalid & (wl >= 0),
                         ucap, (0,))
        okl = uvalid & (od2[Uc] == 1) & (wl >= 0) & (degw == 1)
        nx2 = _set_drop(next_u, torch.where(uvalid, U, cl2),
                        torch.where(okl, wl, -1))
        nxs = _pairswap(nx2)
        pv2 = torch.where(nxs >= 0, nxs ^ 1, -1)
        return (od2, us2, nx2, pv2), kovf | o1 | o2 | o3 | o4

    def degrees(succ, alive, n_loc):
        """Fresh (outdeg, usucc, next_u, prev_u) for the carried-degree
        pass chain (pass 1, and after an update overflow)."""
        _program("dist_degrees")
        _, _, alive_o = _setup(alive, n_loc, succ.device)
        *deg, ovf = _degrees_links(succ, alive_o, rg, gcap4, gcap1)
        return tuple(deg), ovf

    def tips(succ, okv, counts, alive, n_loc, tip_len, deg):
        _program("dist_tips")
        valid_node, ids_g, alive_o = _setup(alive, n_loc, succ.device)
        st = chain_state(okv, counts, alive_o, ids_g, tip_max_len, deg)
        cand = st["is_head"] & ~st["cyc_head"] & (st["length"] <= tip_len)
        start_open = _pairswap(st["outdeg"]) == 0  # indeg(head) == 0
        tails = st["tail_of"]
        (deg_tail,), o7 = rg((st["outdeg"],), tails.clamp(min=0), tails >= 0,
                             gcap1, (1,))
        end_open = (tails >= 0) & (deg_tail == 0)
        doomed = cand & (start_open != end_open)  # heads are local slots
        alive2, o8 = kill_heads(alive, st, doomed)
        deg2, kovf = update_deg(succ, alive2, valid_node, alive & ~alive2,
                                *deg[:3])
        return alive2, doomed.any(), st["ovf"] | o7 | o8, deg2, kovf

    def bubbles(succ, okv, counts, alive, n_loc, bubble_len, deg):
        _program("dist_bubbles")
        dev = succ.device
        valid_node, ids_g, alive_o = _setup(alive, n_loc, dev)
        st = chain_state(okv, counts, alive_o, ids_g, bubble_max_len, deg)
        outdeg, usucc, tails = st["outdeg"], st["usucc"], st["tail_of"]
        (deg_tail, succ_tail), ovf = rg(
            (outdeg, usucc), tails.clamp(min=0), tails >= 0, gcap1, (0, -1))
        ovf |= st["ovf"]
        cand = (st["is_head"] & ~st["cyc_head"]
                & (st["length"] <= bubble_len) & (_pairswap(outdeg) == 1)
                & (tails >= 0) & (deg_tail == 1))
        p = torch.where(cand, _pairswap(usucc) ^ 1, 0)  # unique pred of head
        s = torch.where(cand & (succ_tail >= 0), succ_tail, 0)

        # okv at p, p ^ 1, s, s ^ 1: one canonical gather per endpoint
        pe, po = _paired(okv)
        (p0, p1), o2 = rg_canon((pe, po), p // 2, cand, gcap1, (0, 0))
        (s0, s1), o3 = rg_canon((pe, po), s // 2, cand, gcap1, (0, 0))
        ovf |= o2 | o3
        podd, sodd = (p & 1) == 1, (s & 1) == 1
        okv_p, okv_rp = torch.where(podd, p1, p0), torch.where(podd, p0, p1)
        okv_s, okv_rs = torch.where(sodd, s1, s0), torch.where(sodd, s0, s1)
        proc = (okv_p < okv_rs) | ((okv_p == okv_rs) & (okv_s <= okv_rp))
        selfrc = p == (s ^ 1)
        keep = cand & proc & (~selfrc | (okv <= st["twin"]))

        # group (p, s) on the rank that owns hash(p, s). The candidates
        # are heads of short chains (<< cl2): compacted first, so the
        # route and the receiver's sort run at candidate scale. More than
        # bub_mc of them overflows into the slack ladder, which doubles
        # bub_mc with the route capacities.
        (kp, ks, kcov, kokv, kid), _, nkeep, kovf_c = compact_flagged(
            keep, (p, s, st["cov"], okv, ids_g), bub_mc,
            site="dist_bubble_cands")
        ovf |= kovf_c
        kreal = torch.arange(bub_mc, device=dev) < nkeep.clamp(max=bub_mc)
        mixed = fmix32(mul32(kp.to(I64), 0x9E3779B9) ^ ks.to(I64))
        grp_own = torch.where(kreal, mixed % S, S)
        bcap = _cap_for(bub_mc, S)
        routed, _, o4 = route_buckets(
            tuple(_cols((kp, ks, kcov, kokv, kid))), grp_own, S, bcap, group,
            ledger)
        ovf |= o4
        rp, rs, rcov, rokv, rid = _uncols(routed, (I32, I32, I64, I64, I32))
        # keep the first of each (p, s) group by (coverage desc, okv asc);
        # empty slots (p = EMPTY32) sort last
        ps = (rp.to(I64) << 32) | rs.to(I64)
        order = _lexsort([ps, -rcov, rokv])
        ps_s = ps[order]
        doomed_rec = (rp[order] != EMPTY32) & ~_run_heads(ps_s)
        # kill messages: doomed head ids to their owners
        did = rid[order]
        (kids,), _, o5 = route_buckets(
            (did,), torch.where(doomed_rec, did // cl2, S), S,
            _cap_for(bub_mc, S), group, ledger)
        ovf |= o5
        kloc = torch.where(kids != EMPTY32,
                           (kids - me * cl2).clamp(0, cl2 - 1), cl2)
        doomed = _set_drop(torch.zeros(cl2, dtype=torch.bool, device=dev),
                           kloc, True)
        alive2, o6 = kill_heads(alive, st, doomed)
        deg2, kovf = update_deg(succ, alive2, valid_node, alive & ~alive2,
                                *deg[:3])
        # the router's view of `changed`; the caller agrees it
        return alive2, doomed_rec.any(), ovf | o6, deg2, kovf

    def final(succ, okv, counts, alive, n_loc):
        """The exact final state for emission: (head, dist, primary_node,
        alive_o, ovf), each [cl2] on this rank. Cycles are broken (the
        uncapped chain state), and each head's primary flag (okv <= its
        twin's) is gathered back to every member of its chain, so that
        no rank holds an array of the global graph's size."""
        _program("dist_final_exact")
        _, ids_g, alive_o = _setup(alive, n_loc, succ.device)
        *deg, ovf = _degrees_links(succ, alive_o, rg, gcap4, gcap1)
        st = chain_state(okv, counts, alive_o, ids_g, None, deg)
        head = st["head"]
        prim_head = st["is_head"] & (okv <= st["twin"])
        (pm,), o = rg((prim_head.to(I32),), head.clamp(min=0),
                      alive_o & (head >= 0), gcap1, (0,))
        primary = alive_o & (head >= 0) & (pm != 0)
        return head, st["dist"], primary, alive_o, ovf | st["ovf"] | o

    return tips, bubbles, final, degrees


def make_sharded_final(group, local_capacity: int, slack: float = 1.35,
                       ledger: ExchangeLedger | None = None):
    """The exact sharded final state at one slack rung (make_sharded_
    simplify's `final`)."""
    return make_sharded_simplify(group, local_capacity, slack,
                                 ledger=ledger)[2]


def make_sharded_final_fast(group, local_capacity: int, slack: float = 1.35,
                            ledger: ExchangeLedger | None = None):
    """The sharded final state by ruler ranking: a per-rank function
    (succ, okv, counts, alive, n_loc) -> (head, dist, primary_node,
    alive_o, ok, ovf, (p1_rounds, p2_rounds)).

    Where the exact final pays ~log2(ids) full-size gather rounds three
    times (doubling, the cycles' min-doubling, doubling again), this
    runs phase 1, an early-exit (p, d) doubling frozen at rulers and
    heads (~log2 of the longest ruler gap, about 8-13 rounds); phase 2,
    the same doubling over the ruler arrays alone (1/RULER_STRIDE of the
    ids); then the composition, one tail-to-head twin routing and one
    primary gather-back. It has no cycle machinery: a surviving cycle or
    a ruler gap past _P1_CAP rounds gives ok = False (agreed: each
    phase's exit is), and the caller takes the exact final. ok and ovf
    are 0-dim tensors of this rank; the caller agrees them."""
    S, me = dist.get_world_size(group), dist.get_rank(group)
    cl = local_capacity
    cl2 = 2 * cl
    if cl2 % RULER_STRIDE:
        raise ValueError(f"2 * local_capacity = {cl2} is not a multiple of "
                         f"RULER_STRIDE = {RULER_STRIDE}")
    rl = cl2 // RULER_STRIDE  # rulers a rank
    rounds_cap = max(1, (S * cl2 - 1).bit_length() + 1)
    p1_cap = min(rounds_cap, _P1_CAP)
    gcap1 = _cap_for(cl2, S, slack)
    gcap4 = _cap_for(4 * cl2, S, slack)
    rcap = _cap_for(rl, S, slack)
    caps = (S, cl, gcap1, gcap4, rcap)  # the ledger's program key
    rg, seg_route = make_ops(group, cl2, ledger)
    # local ruler j is global id me * cl2 + j * RULER_STRIDE, global
    # ruler index me * rl + j: contiguous a rank, so the ruler gather's
    # owner idx // rl is exact
    rg_rul, _ = make_ops(group, rl, ledger)
    umask = RULER_STRIDE - 1

    def early_exit(step, carry, cap):
        """carry, changed = step(carry) until no rank changed or `cap`
        rounds: JAX's while_loop, whose exit test psum(changed) > 0 is
        the host-read agreement all_any_each here; costed in the ledger
        at its cap. Returns (carry, rounds run, converged)."""
        go, i = True, 0
        scope = (ledger.loop(cap) if ledger is not None
                 else contextlib.nullcontext(lambda: None))
        with scope as round_done:
            while go and i < cap:
                carry, ch = step(carry)
                if ledger is not None:
                    ledger.record_psum()
                go = all_any_each([ch], group)[0]
                i += 1
                round_done()
        return carry, i, not go

    def fast(succ, okv, counts, alive, n_loc):
        if ledger is not None:
            ledger.program("dist_final_fast", caps)
        dev = succ.device
        valid_node = torch.arange(cl, device=dev) < n_loc
        ids_g = me * cl2 + torch.arange(cl2, dtype=I32, device=dev)
        alive_o = torch.repeat_interleave(alive & valid_node, 2)
        _, _, next_u, prev_u, o = _degrees_links(succ, alive_o, rg, gcap4,
                                                 gcap1)
        ovf = [o]

        def p1(carry):
            """(p, d) doubling frozen at rulers and at heads (a head
            gathers itself: p[p] == p)."""
            p, d = carry
            adv = (p & umask) != 0
            (pg, dg), o = rg((p, d), p, adv, gcap1, (p, 0))
            ovf.append(o)
            return ((torch.where(adv, pg, p), d + torch.where(adv, dg, 0)),
                    (adv & (pg != p)).any())

        def p2(carry):
            """The same over the ruler arrays: a ruler whose target is a
            ruler jumps."""
            rp, rd = carry
            adv = (rp & umask) == 0
            (pg, dg), o = rg_rul((rp, rd), (rp // RULER_STRIDE).clamp(min=0),
                                 adv, rcap, (rp, 0))
            ovf.append(o)
            return ((torch.where(adv, pg, rp), rd + torch.where(adv, dg, 0)),
                    (adv & (pg != rp)).any())

        (p, d), i1, p1_ok = early_exit(
            p1, (torch.where(prev_u >= 0, prev_u, ids_g),
                 (prev_u >= 0).to(I32)), p1_cap)
        (rp, rd), i2, p2_ok = early_exit(
            p2, (p[::RULER_STRIDE].contiguous(),
                 d[::RULER_STRIDE].contiguous()), rounds_cap)

        # compose: the nearest ruler-or-head ancestor -> its ranked head.
        # A rank asks one owner for at most rl distinct rulers (those it
        # owns), so capacity rl cannot overflow.
        a_rul = (p & umask) == 0
        (hp, hd), o = rg_rul((rp, rd), (p // RULER_STRIDE).clamp(min=0),
                             a_rul, rl, (p, 0))
        ovf.append(o)
        head = torch.where(alive_o, torch.where(a_rul, hp, p), -1)
        dist_ = torch.where(alive_o, d + torch.where(a_rul, hd, 0), 0)
        is_head = alive_o & (head == ids_g)

        # each head's twin okv = okv(rc(tail)): one tail a chain (a cycle
        # has none, and ok excludes cycles), routed to the head's owner
        is_tail = alive_o & (next_u == -1)
        lseg, (r_okv,), _, o = seg_route(
            (_pairswap(okv),), ("min",), head.clamp(min=0),
            is_tail & (head >= 0), gcap1)
        ovf.append(o)
        twin = _seg_reduce(r_okv, lseg.long(), cl2, "min", INT64_MAX)

        # the primary flag, set at the head's owner and gathered back to
        # every member; prev_u rides along: a composed head with a live
        # predecessor is an undetected cycle (ok = False)
        prim_head = is_head & (okv <= twin)
        (pm, pv), o = rg((prim_head.to(I32), prev_u), head.clamp(min=0),
                         alive_o & (head >= 0), gcap1, (0, -1))
        ovf.append(o)
        primary = alive_o & (head >= 0) & (pm != 0)
        head_bad = (alive_o & (head >= 0) & (pv >= 0)).any()
        ok = ~head_bad & p1_ok & p2_ok
        return (head, dist_, primary, alive_o, ok,
                torch.stack(ovf).any(), (i1, i2))

    return fast


def final_state_sharded(succ, okv, counts, alive, n_loc: int, group=None,
                        metrics=None, ledger: ExchangeLedger | None = None):
    """The sharded final state with its ladder: this rank's part; every
    rank of the group calls it.

    The ruler-ranking fast final first, retried with doubled slack on a
    route overflow (_SLACK_RUNGS rungs); its ok = False is structural (a
    cycle survived simplification, or a ruler gap passed the round cap),
    so it goes straight to the exact final, which has a ladder of its
    own. Every flag is agreed before a branch.

    Returns (head, dist, primary_node, alive_o, overflowed): this rank's
    [cl2] tensors, and True only when the exact ladder was used up."""
    cl = alive.shape[0]
    slack = 1.35
    for _ in range(_SLACK_RUNGS):
        fast = make_sharded_final_fast(group, cl, slack, ledger)
        head, dist_, primary, alive_o, ok, ovf, rnds = fast(
            succ, okv, counts, alive, n_loc)
        if ledger is not None:
            ledger.invoke("dist_final_fast")
        ovf, bad = all_any_each([ovf, ~ok], group)
        if not ovf:
            if not bad:
                if metrics is not None:
                    metrics.log("dist_final_fast_rounds", p1=rnds[0],
                                p2=rnds[1])
                return head, dist_, primary, alive_o, False
            count("retries")
            if metrics is not None:
                metrics.log("dist_final_fast_fallback")
            break
        count("retries")
        slack *= 2.0
        if metrics is not None:
            metrics.log("dist_final_fast_overflow_retry", slack=slack)
    slack = 1.35
    for _ in range(_SLACK_RUNGS):
        final = make_sharded_final(group, cl, slack, ledger)
        head, dist_, primary, alive_o, ovf = final(succ, okv, counts, alive,
                                                   n_loc)
        if ledger is not None:
            ledger.invoke("dist_final_exact")
        if not all_any_each([ovf], group)[0]:
            return head, dist_, primary, alive_o, False
        count("retries")
        slack *= 2.0
        if metrics is not None:
            metrics.log("dist_final_overflow_retry", slack=slack)
    return head, dist_, primary, alive_o, True


def simplify_sharded(succ, okv, counts, alive, n_loc: int, params,
                     group=None, ledger: ExchangeLedger | None = None):
    """Host fixpoint loop over the sharded passes (SEMANTICS §5 order):
    this rank's part; every rank of the group calls it.

    Degrees are carried from pass to pass, recomputed fresh on pass 1 and
    after an incremental-update overflow. On a route overflow the loop
    starts again from the initial alive mask with doubled slack (1.35,
    2.7, 5.4); the results of an overflowed attempt are discarded. Every
    flag is agreed across the ranks before a branch, so all ranks take
    the same one.

    Returns (alive, overflowed): this rank's alive [cl] bool, and True
    (with the initial mask) only when every rung overflowed."""
    alive0 = alive
    slack = 1.35
    for _attempt in range(_SLACK_RUNGS):
        tips, bubbles, _, degrees = make_sharded_simplify(
            group, alive.shape[0], slack, params.tip_len_eff,
            params.bubble_len_eff, ledger)

        def fresh(alive_now):
            deg, dovf = degrees(succ, alive_now, n_loc)
            if ledger is not None:
                ledger.invoke("dist_degrees")
            return deg, all_any_each([dovf], group)[0]

        def run(fn, name, threshold, alive_now, deg):
            alive2, changed, ovf, deg2, kovf = fn(
                succ, okv, counts, alive_now, n_loc, threshold, deg)
            if ledger is not None:
                ledger.invoke(name)
            ovf, kovf, changed = all_any_each([ovf, kovf, changed], group)
            return alive2, changed, ovf, None if kovf else deg2

        alive = alive0
        overflowed = False
        deg = None
        for _ in range(params.max_rounds):
            if deg is None:
                deg, overflowed = fresh(alive)
                if overflowed:
                    break
            alive, c1, overflowed, deg = run(
                tips, "dist_tips", params.tip_len_eff, alive, deg)
            if overflowed:
                break
            if deg is None:
                deg, overflowed = fresh(alive)
                if overflowed:
                    break
            alive, c2, overflowed, deg = run(
                bubbles, "dist_bubbles", params.bubble_len_eff, alive, deg)
            if overflowed or not (c1 or c2):
                break
        if not overflowed:
            return alive, False
        count("retries")
        slack *= 2.0
    return alive0, True
