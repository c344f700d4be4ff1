"""de Bruijn graph construction on device (SURVEY.md §2.4, §3.1).

Port of genome_tpu/graph/build.py: build_graph_kjoin, the (k-1)-mer
suffix/prefix join (the default, build_graph_device), and the two builds
the JAX package keeps as oracles, build_graph_bsearch (a binary search of
every extension query) and build_graph_join (one sort of the table and
the queries). Each returns the same succ [2C, 4] int32 oriented successor
ids (-1 = absent), oriented id v = 2*i + s (SEMANTICS §3), and okv [2C]
int64 oriented k-mer values (even rows = table, odd rows = revcomp).
Table slots at or beyond n_unique yield rows of -1.
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.compact import compact_flagged
from genome_tpu_torch.kernels.keys import INT64_MAX


def searchsorted_pair(table: torch.Tensor, n_valid, q: torch.Tensor):
    """Lower-bound search of queries `q` in the sorted table; entries at
    index >= n_valid count as +inf. Returns int32 insertion positions
    (0..n_valid). JAX's contract, with one int64 key in place of the
    (hi, lo) pair."""
    return torch.searchsorted(table[: int(n_valid)], q.contiguous(),
                              out_int32=True)


def _extension_queries(table: torch.Tensor, n_unique, k: int):
    """Shared prep of the oracle builds: the oriented values and, for each
    base b, the canonical form of every extension okv << 2 | b (masked to
    2k bits) with its orientation bit.

    Returns (okv [2C], valid_o [2C], queries [4][2C], orients [4][2C])."""
    capacity = table.shape[0]
    valid_o = torch.repeat_interleave(
        torch.arange(capacity, device=table.device) < n_unique, 2)
    okv = torch.stack([table, keys.revcomp(table, k)], dim=1).reshape(-1)
    shifted = (okv << 2) & keys.kmer_mask(k)
    queries, orients = [], []
    for b in range(4):
        ext = shifted | b
        c = keys.canonical(ext, k)
        queries.append(c)
        orients.append((ext != c).to(torch.int32))
    return okv, valid_o, queries, orients


def build_graph_bsearch(table: torch.Tensor, n_unique, k: int):
    """Graph build by a binary search of each of the 8C extension queries
    (an oracle, as in the JAX package). Returns (succ, okv)."""
    capacity = table.shape[0]
    okv, valid_o, queries, orients = _extension_queries(table, n_unique, k)
    cols = []
    for q, orient in zip(queries, orients):
        pos = searchsorted_pair(table, n_unique, q)
        pos_c = pos.clamp(max=capacity - 1)
        found = (pos < n_unique) & (table[pos_c] == q)
        cols.append(torch.where(found & valid_o, 2 * pos_c + orient, -1))
    return torch.stack(cols, dim=1).to(torch.int32), okv


def build_graph_join(table: torch.Tensor, n_unique, k: int):
    """Graph build as a sort-merge membership join (an oracle, as in the
    JAX package): the table entries and all 8C extension queries sorted
    once; a query is answered by the table record at its run's head.
    Records are laid out table first, queries after, so a stable sort by
    key orders each run as JAX's (key, payload) sort does. Returns
    (succ, okv)."""
    dev = table.device
    capacity = table.shape[0]
    n2 = 2 * capacity
    okv, valid_o, queries, orients = _extension_queries(table, n_unique, k)
    valid_node = torch.arange(capacity, device=dev) < n_unique
    rec = torch.cat([torch.where(valid_node, table, INT64_MAX)]
                    + [torch.where(valid_o, q, INT64_MAX) for q in queries])
    rec, payload = torch.sort(rec, stable=True)
    first = torch.ones_like(rec, dtype=torch.bool)
    first[1:] = rec[1:] != rec[:-1]
    head_payload = payload[first][torch.cumsum(first, 0) - 1]
    is_query = payload >= capacity
    hit = is_query & (head_payload < capacity) & (rec != INT64_MAX)
    answers = torch.full((4 * n2 + 1,), -1, dtype=torch.int64, device=dev)
    answers[torch.where(hit, payload - capacity, 4 * n2)] = head_payload
    answers = answers[:-1]
    orient = torch.cat(orients)
    succ = torch.where(answers >= 0, 2 * answers + orient, -1)
    return succ.reshape(4, n2).t().contiguous().to(torch.int32), okv


def build_graph_kjoin(table: torch.Tensor, n_unique, k: int):
    """Graph build as a (k-1)-mer suffix/prefix join.

    An edge u->v exists iff suffix_{k-1}(okv(u)) == prefix_{k-1}(okv(v)).
    One prefix record (side B) and one suffix record (side A) per oriented
    node, keyed by (k-1)-mer << 1 | side so B records sort first in their
    run; a run holds <= 4 B and <= 4 A records, so every A record sees all
    of its run's B records within the previous 7 positions. Invalid
    records get INT64_MAX - 1 (B) / INT64_MAX (A): the side bit survives.

    Returns (succ [2C, 4] int32, okv [2C] int64)."""
    dev = table.device
    capacity = table.shape[0]
    n2 = 2 * capacity
    valid_o = torch.repeat_interleave(
        torch.arange(capacity, device=dev) < n_unique, 2)
    okv = torch.stack([table, keys.revcomp(table, k)], dim=1).reshape(-1)

    suffix = okv & ((1 << (2 * k - 2)) - 1)
    prefix = okv >> 2
    oid = torch.arange(n2, dtype=torch.int64, device=dev)
    rec = torch.cat([torch.where(valid_o, prefix << 1, INT64_MAX - 1),
                     torch.where(valid_o, (suffix << 1) | 1, INT64_MAX)])
    payload = torch.cat([(oid << 2) | (okv & 3), oid << 2])
    rec, perm = torch.sort(rec)
    payload = payload[perm]

    is_b = (rec & 1) == 0
    vid = (payload >> 2).to(torch.int32)
    vb = payload & 3
    slots = torch.stack([torch.where(is_b & (vb == b), vid, -1)
                         for b in range(4)], dim=1)
    run = rec >> 1
    bcast = slots.clone()
    for s in range(1, 8):
        same = run[s:] == run[:-s]
        bcast[s:] = torch.maximum(
            bcast[s:], torch.where(same[:, None], slots[:-s], -1))
    succ_rows = torch.where((~is_b & (rec < INT64_MAX - 1))[:, None],
                            bcast, -1)

    # every oriented id occurs exactly once as an A record: compact the A
    # records (halves the stream), then route rows by their id
    a_oid = torch.where(is_b, n2, vid)
    cols = tuple(succ_rows[:, b].contiguous() for b in range(4))
    (a_oid, *cols), _, _, _ = compact_flagged(~is_b, (a_oid,) + cols, n2,
                                              site="build")
    succ = torch.empty((n2, 4), dtype=torch.int32, device=dev)
    succ[a_oid.long()] = torch.stack(cols, dim=1)
    return succ, okv


# default: the (k-1)-join build; the extension join and the binary search
# are oracles
build_graph_device = build_graph_kjoin
