"""Open-addressing hash-table counting in batched rounds (port of
genome_tpu/kernels/hash_table.py, plain XLA there, plain torch here).

Whole batches insert in lock-step rounds: every pending window probes one
slot (linear probing by round offset); matches add their count with
`index_add_`, empty slots are claimed by the smallest window index
(`scatter_reduce_("amin")`, a unique winner), and windows whose slot does
not hold their key after the claims advance. The round loop runs on the
host, one read-back per round, and stops after `max_rounds` with the
overflow flag set (retry with a larger capacity). The table is then
sorted, filtered and compacted by count_weighted, so the output contract
is count_kmers_device's.
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels.count import _empty, count_weighted
from genome_tpu_torch.kernels.keys import SENTINEL, hash32


def count_kmers_hashtable(keys, min_coverage, capacity: int,
                          max_rounds: int = 64):
    """Canonical int64 k-mer stream -> sorted unique table via a hash table.

    capacity must be a power of two and should be >= 2x the expected
    unique count (open addressing needs load-factor headroom)."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of 2, got {capacity}")
    m = keys.shape[0]
    dev = keys.device
    if m == 0:
        return _empty(capacity, dev)

    idx = torch.arange(m, device=dev)
    h0 = hash32(keys)
    done = keys == SENTINEL  # invalid windows never insert
    # slot `capacity` of each buffer is the drop slot
    t_keys = torch.full((capacity + 1,), SENTINEL, dtype=torch.int64,
                        device=dev)
    t_cnt = torch.zeros(capacity, dtype=torch.int64, device=dev)
    p = torch.zeros(m, dtype=torch.int64, device=dev)
    for _ in range(max_rounds):
        if bool(done.all()):
            break
        slot = (h0 + p) & (capacity - 1)
        cur = t_keys[slot]
        match = ~done & (cur == keys)
        t_cnt.index_add_(0, slot, match.to(torch.int64))
        done = done | match
        empty = ~done & (cur == SENTINEL)
        claim = torch.full((capacity + 1,), m, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(empty, slot, capacity), idx,
                              "amin")
        winner = empty & (claim[slot] == idx)
        t_keys.scatter_(0, torch.where(winner, slot, capacity), keys)
        # advance only if the slot (after this round's claims) does not
        # hold our key: winners and same-key claim losers stay and match
        # next round; advancing them would insert duplicate keys
        stays = t_keys[slot] == keys
        p = torch.where(~done & ~stays, p + 1, p)
    overflow = ~done.all()

    res = count_weighted(t_keys[:capacity], t_cnt, min_coverage, capacity)
    res["overflow"] = overflow | res["overflow"]
    return res
