"""Sharded k-mer counting over a process group (port of
genome_tpu/dist/count.py; SURVEY.md §3.4).

Every rank extracts the k-mers of its own read shard, buckets them by
owner hash, and one all_to_all delivers each bucket to its owner, which
counts locally with count_kmers_device (the compact_flagged kernel at
count_heads and count_filter). Bucket capacities are fixed per call; an
overflow is agreed across the ranks and the caller retries bigger.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import all_any, all_max, all_to_all_rows
from genome_tpu_torch.dist.partition import owner_of
from genome_tpu_torch.kernels.count import count_kmers_device
from genome_tpu_torch.kernels.keys import SENTINEL

# the empty slot of an int32 route: above every global node id, so it
# sorts after each of them as JAX's 0xFFFFFFFF does
EMPTY32 = (1 << 31) - 1


def route_buckets(vals: tuple, owner: torch.Tensor, num_shards: int,
                  bucket_cap: int, group=None,
                  ledger: ExchangeLedger | None = None):
    """Bucket values by owner and exchange them with one all_to_all
    (JAX dist/count.py::route_buckets).

    `vals` are local [M] tensors of one dtype: int64 keys (the count, the
    build) or int32 columns (the sharded simplify, JAX's 32-bit words);
    `owner` is [M] in [0, num_shards), or >= num_shards to drop the slot.
    Returns (received: one [num_shards * bucket_cap] tensor per value,
    empty slots SENTINEL for int64 and EMPTY32 for int32; send_pos [M]
    int32, each element's flat send slot, -1 if dropped; overflow, a 0-dim
    bool tensor set when some bucket holds more than bucket_cap).

    Layout: the buffer row j goes to rank j and lands there as row `me`,
    at the same positions, so a response buffer routed back restores the
    sender's slots. The values ride stacked column-wise in one [S,
    len(vals) * cap] buffer: one collective whatever their number."""
    S, m, dev = num_shards, owner.shape[0], owner.device
    owner = torch.where(owner < S, owner.to(torch.int32), S)
    so, sidx = torch.sort(owner, stable=True)
    # bucket j is so[start[j] : start[j + 1]]: its bounds by a search of
    # the sorted owners (a bincount's atomics on S + 1 bins serialise)
    start = torch.searchsorted(
        so, torch.arange(S + 2, dtype=torch.int32, device=dev))
    per = start[1:] - start[:-1]
    so = so.to(torch.int64)
    pos = torch.arange(m, device=dev) - start[so]  # rank within its bucket
    overflow = (per[:S] > bucket_cap).any()
    n_slots = S * bucket_cap
    dest = torch.where((so < S) & (pos < bucket_cap), so * bucket_cap + pos,
                       n_slots)
    send_pos = torch.empty(m, dtype=torch.int32, device=dev)
    send_pos[sidx] = torch.where(dest < n_slots, dest, -1).to(torch.int32)
    del so, pos  # the route's temporaries go before its buffers come
    # slot n_slots of each row is the drop slot
    dtype = vals[0].dtype
    buf = torch.full((len(vals), n_slots + 1),
                     SENTINEL if dtype == torch.int64 else EMPTY32,
                     dtype=dtype, device=dev)
    for j, v in enumerate(vals):
        buf[j, dest] = v[sidx]
    del sidx, dest
    stacked = buf[:, :n_slots].reshape(len(vals), S, bucket_cap)
    stacked = stacked.permute(1, 0, 2).reshape(S, len(vals) * bucket_cap)
    out = all_to_all_rows(stacked, group)
    if ledger is not None:
        ledger.record_a2a(S, stacked.numel() * stacked.element_size())
    received = tuple(out[:, j * bucket_cap : (j + 1) * bucket_cap].reshape(-1)
                     for j in range(len(vals)))
    return received, send_pos, overflow


def sharded_count(keys: torch.Tensor, min_coverage, bucket_cap: int,
                  local_capacity: int, group=None,
                  ledger: ExchangeLedger | None = None) -> dict:
    """One rank's part of the sharded count (the body of JAX
    make_sharded_count): route this rank's window stream (SENTINEL slots
    are dropped) to the owners and count what arrives.

    Returns count_kmers_device's table dict of the keys this rank owns,
    with `overflow` the host bool of route | count overflow on any rank
    (the same on every rank: retry bigger)."""
    S = dist.get_world_size(group)
    if ledger is not None:
        ledger.program("dist_count", (bucket_cap, local_capacity))
    own = torch.where(keys != SENTINEL, owner_of(keys, S), S)
    (received,), _, ovf_route = route_buckets((keys,), own, S, bucket_cap,
                                              group, ledger)
    del own  # not held through the count's sort
    res = count_kmers_device(received, min_coverage, local_capacity)
    res["overflow"] = all_any(bool(ovf_route | res["overflow"]), group)
    return res


def shrink_tables(local_cap: int, table: torch.Tensor, counts: torch.Tensor,
                  n_unique, group=None):
    """Cut every rank's count table to the smallest power of two (at least
    2^13) that holds the largest rank's unique count (JAX
    dist/count.py::shrink_tables). The count capacity is sized from the
    window stream, 10-20x the unique count at 20-30x coverage; build and
    simplify would pay that padding. Returns (table, counts, local_cap)."""
    n_max = all_max(int(n_unique), group)
    cap2 = 1 << max(13, (max(n_max, 1) - 1).bit_length())
    if cap2 >= local_cap:
        return table, counts, local_cap
    return table[:cap2].clone(), counts[:cap2].clone(), cap2
