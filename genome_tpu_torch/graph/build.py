"""de Bruijn graph construction on device (SURVEY.md §2.4, §3.1).

Port of genome_tpu/graph/build.py::build_graph_kjoin, the (k-1)-mer
suffix/prefix join. Output: succ [2C, 4] int32 oriented successor ids
(-1 = absent), oriented id v = 2*i + s (SEMANTICS §3), and okv [2C] int64
oriented k-mer values (even rows = table, odd rows = revcomp). Table
slots at or beyond n_unique yield rows of -1.
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.compact import compact_flagged
from genome_tpu_torch.kernels.keys import INT64_MAX


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


# default build (the JAX package keeps the other builds as oracles)
build_graph_device = build_graph_kjoin
