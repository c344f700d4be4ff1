"""Bucket-partition sort and counter for int64 k-mer keys (port of
genome_tpu/kernels/sort_bucket.py, plain XLA there, plain torch here).

The stream is partitioned into B = 2^bucket_bits value-ordered buckets
(the top bits of the 2k-bit key): a stable per-row sort by bucket id, one
per-(row, bucket) histogram, an exclusive prefix over rows, and one
scatter into B fixed-size regions of `seg` slots; then each region is
sorted on its own. Output contract (the sorter contract of
kernels/count.py): non-sentinel keys globally ascending, equal keys
adjacent; SENTINEL holes sit at region tails.

Canonical keys skew low (min(x, rc(x))), so `seg` defaults to 3x the
average bucket load and an overfull bucket raises the overflow flag for a
retry with a larger `seg`; nothing is dropped silently.
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels.count import _empty, count_weighted
from genome_tpu_torch.kernels.keys import SENTINEL


def _identity_sorter(keys, w):
    return keys, w


def default_seg(n: int, bucket_bits: int = 10, row: int = 8192) -> int:
    """Default per-bucket region size: 3x the average load, a multiple of
    256, at least one row."""
    B = 1 << bucket_bits
    return max(row, -(-3 * n // (B * 256)) * 256)


def _bucket_ids(keys, k: int, bucket_bits: int):
    """Top `bucket_bits` of the 2k-bit key, clamped to the last bucket;
    SENTINEL gets the virtual bucket B, which is never materialised."""
    B = 1 << bucket_bits
    b = torch.clamp(keys >> (2 * k - bucket_bits), max=B - 1)
    return torch.where(keys == SENTINEL, B, b)


def bucket_partition_sort(keys, w, k: int, bucket_bits: int = 10,
                          row: int = 8192, seg: int = 0):
    """Returns (keys', w', overflow): sorted-with-holes (module doc),
    B * seg slots. seg: per-bucket region size; 0 -> default_seg."""
    n = keys.shape[0]
    dev = keys.device
    bucket_bits = min(bucket_bits, 2 * k)
    B = 1 << bucket_bits
    if seg == 0:
        seg = default_seg(n, bucket_bits, row)
    nn = -(-n // row) * row
    if nn != n:
        keys = torch.cat([keys, keys.new_full((nn - n,), SENTINEL)])
        w = torch.cat([w, w.new_zeros(nn - n)])
    T = nn // row

    # per-row stable sort by bucket; sentinels (bucket B) go last
    sb, order = torch.sort(_bucket_ids(keys, k, bucket_bits).view(T, row),
                           dim=1, stable=True)
    sk = torch.gather(keys.view(T, row), 1, order)
    sw = torch.gather(w.view(T, row), 1, order)

    # histogram per (row, bucket) and exclusive prefix over rows
    flat_id = (torch.arange(T, device=dev).view(T, 1) * (B + 1)
               + sb).reshape(-1)
    hist = torch.bincount(flat_id, minlength=T * (B + 1)).view(T, B + 1)
    overflow = (hist[:, :B].sum(0) > seg).any()
    pre = torch.cumsum(hist, 0) - hist  # rows before me, same bucket

    # rank within the (row, bucket) run = column - run start
    col = torch.arange(row, device=dev).expand(T, row)
    newrun = torch.ones(T, row, dtype=torch.bool, device=dev)
    newrun[:, 1:] = sb[:, 1:] != sb[:, :-1]
    runstart = torch.cummax(torch.where(newrun, col, 0), dim=1).values
    within = torch.gather(pre, 1, sb) + (col - runstart)
    ok = (within < seg) & (sb < B)  # drop overflow and the sentinel bucket
    dest = torch.where(ok, sb * seg + within, B * seg).reshape(-1)

    # one scatter into B regions (+1 drop slot), then per-region sorts
    big = B * seg
    out_k = keys.new_full((big + 1,), SENTINEL).scatter_(0, dest,
                                                         sk.reshape(-1))
    out_w = w.new_zeros(big + 1).scatter_(0, dest, sw.reshape(-1))
    rk, idx = torch.sort(out_k[:big].view(B, seg), dim=1)
    rw = torch.gather(out_w[:big].view(B, seg), 1, idx)
    return rk.reshape(-1), rw.reshape(-1), overflow


def count_kmers_bucket(keys, min_coverage, capacity: int, k: int,
                       bucket_bits: int = 10, row: int = 8192, seg: int = 0):
    """Counting via bucket-partition sort; contract of count_kmers_device
    (overflow also set when a bucket overflows its region)."""
    if keys.shape[0] == 0:
        return _empty(capacity, keys.device)
    w = torch.ones(keys.shape[0], dtype=torch.int32, device=keys.device)
    sk, sw, bovf = bucket_partition_sort(keys, w, k, bucket_bits, row, seg)
    res = count_weighted(sk, sw, min_coverage, capacity,
                         sorter=_identity_sorter)
    res["overflow"] = res["overflow"] | bovf
    return res
