"""Sharded de Bruijn graph build: the boundary k-mer exchange (port of
genome_tpu/dist/build.py; SURVEY.md §3.4).

Each rank owns a sorted local table of canonical k-mers. To fill its
successor array it probes the extensions of its nodes, whose canonical
forms other ranks may own: the queries are bucketed by owner hash and
exchanged (all_to_all), answered at the owner by a lower-bound search of
its table, and the response buffer goes back the same way (a second
all_to_all); positions in a bucket are kept, so each response lands in
its query's slot.

Global oriented node id: v = 2 * (rank * local_capacity + j) + s.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from genome_tpu_torch.dist.count import route_buckets
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import all_any, all_to_all_rows
from genome_tpu_torch.dist.partition import owner_of
from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.keys import INT64_MAX, SENTINEL


def oriented_values(table: torch.Tensor, k: int) -> torch.Tensor:
    """okv [2C]: even slots the stored k-mer, odd slots its reverse
    complement."""
    return torch.stack([table, keys.revcomp(table, k)], dim=1).reshape(-1)


def sharded_build(table: torch.Tensor, n_unique, k: int,
                  local_capacity: int, query_cap: int, group=None,
                  ledger: ExchangeLedger | None = None):
    """One rank's part of the sharded build (the body of JAX
    make_sharded_build).

    `table` is this rank's sorted table [local_capacity] with n_unique
    valid entries. Returns (succ [2 * local_capacity, 4] int32 of global
    oriented ids, -1 absent; okv [2 * local_capacity] int64; overflow, the
    host bool of a query bucket overflow on any rank: retry bigger)."""
    S, me = dist.get_world_size(group), dist.get_rank(group)
    if ledger is not None:
        ledger.program("dist_build", (local_capacity, query_cap))
    cl, dev = local_capacity, table.device
    n = int(n_unique)
    valid_node = torch.arange(cl, device=dev) < n
    okv = oriented_values(table, k)

    # 2 * cl oriented nodes x 4 bases, base-major -> canonical queries
    shifted = (okv << 2) & keys.kmer_mask(k)
    ext = torch.cat([shifted | b for b in range(4)])
    query = keys.canonical(ext, k)
    q_orient = (ext != query).to(torch.int32)
    q_valid = torch.repeat_interleave(valid_node, 2).repeat(4)
    own = torch.where(q_valid, owner_of(query, S), S)
    (rq,), send_pos, ovf = route_buckets((query,), own, S, query_cap, group,
                                         ledger)

    # answer the received queries: lower bound over the first n entries
    # (the table's tail is 0, so it must read as +inf, not be searched)
    bounded = torch.where(valid_node, table, INT64_MAX)
    pos = torch.searchsorted(bounded, rq).clamp(max=cl - 1)
    found = valid_node[pos] & (table[pos] == rq) & (rq != SENTINEL)
    resp = torch.where(found, me * cl + pos, -1).to(torch.int32)
    back = all_to_all_rows(resp.reshape(S, query_cap), group).reshape(-1)
    if ledger is not None:
        ledger.record_a2a(S, resp.numel() * resp.element_size())

    # each query's response, from its send slot
    g = torch.where((send_pos >= 0) & q_valid,
                    back[send_pos.clamp(min=0).long()], -1)
    succ = torch.where(g >= 0, 2 * g + q_orient, -1)
    return (succ.reshape(4, 2 * cl).T.contiguous(), okv,
            all_any(bool(ovf), group))
