"""k-mer counting on device = sort + run-length encoding (SURVEY.md §2.4).

Port of genome_tpu/kernels/count.py. The whole int64 window stream is
sorted with one single-key sort (the JAX two-word (hi, lo) sort becomes
one int64 key), run heads are compacted with the stream compactor
(kernels/compact.py), counts come from head-position differences, and
the coverage filter is a second compaction. SENTINEL (INT64_MAX) runs are
dropped by value: INT64_MAX is never a canonical k-mer for k <= 31.

A table is a dict: table int64 [capacity] (sorted keys, 0 beyond
n_unique), counts int32 [capacity], n_unique (0-dim int64), overflow
(0-dim bool, set when the run count exceeds capacity — retry bigger).
"""

from __future__ import annotations

import torch

from genome_tpu_torch.kernels.compact import compact_flagged
from genome_tpu_torch.kernels.keys import SENTINEL


def _empty(capacity: int, device) -> dict:
    return dict(table=torch.zeros(capacity, dtype=torch.int64, device=device),
                counts=torch.zeros(capacity, dtype=torch.int32, device=device),
                n_unique=torch.zeros((), dtype=torch.int64, device=device),
                overflow=torch.zeros((), dtype=torch.bool, device=device))


def _dense_prefix(valid, table, counts, capacity: int, site: str):
    """Compact the valid (table, counts) slots to the front, zeros after."""
    (tk, tc), _, n, _ = compact_flagged(
        valid, (table, counts.to(torch.int32)), capacity, site=site)
    keep = torch.arange(capacity, device=valid.device) < n
    return torch.where(keep, tk, 0), torch.where(keep, tc, 0), n


def _run_heads(s):
    first = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    first[1:] = s[1:] != s[:-1]
    return first


def count_kmers_device(keys: torch.Tensor, min_coverage, capacity: int):
    """Unweighted counting of the raw window stream (every slot counts 1).

    Sorts only the keys and derives run counts from head-position
    differences (no segment-sum scatter). Returns the table dict."""
    m = keys.shape[0]
    dev = keys.device
    if m == 0:
        return _empty(capacity, dev)
    s = torch.sort(keys).values
    (run_keys,), starts, n_runs, overflow = compact_flagged(
        _run_heads(s), (s,), capacity, site="count_heads")
    ridx = torch.arange(capacity, device=dev)
    in_range = ridx < n_runs
    ends = torch.cat([starts[1:], starts.new_full((1,), m)])
    ends = torch.where(ridx + 1 < n_runs, ends, m)
    counts = torch.where(in_range, ends - starts, 0)
    run_keys = torch.where(in_range, run_keys, 0)
    valid = in_range & (run_keys != SENTINEL) & (counts >= min_coverage)
    table, out_counts, n_unique = _dense_prefix(
        valid, run_keys, counts, capacity, "count_filter")
    return dict(table=table, counts=out_counts, n_unique=n_unique,
                overflow=overflow)


def count_weighted(keys: torch.Tensor, weights: torch.Tensor, min_coverage,
                   capacity: int):
    """Weighted stream (weights = existing counts when merging tables) ->
    sorted unique table, filtered at min_coverage."""
    m = keys.shape[0]
    dev = keys.device
    if m == 0:
        return _empty(capacity, dev)
    s, perm = torch.sort(keys)
    sw = weights[perm].to(torch.int64)
    first = _run_heads(s)
    run_id = torch.cumsum(first, 0) - 1
    n_runs = first.sum()
    counts = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, run_id.clamp(max=capacity), sw)
    counts = counts[:capacity]
    run_keys = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    run_keys[torch.where(first, run_id, capacity).clamp(max=capacity)] = s
    run_keys = run_keys[:capacity]
    ridx = torch.arange(capacity, device=dev)
    valid = ((ridx < n_runs) & (run_keys != SENTINEL)
             & (counts >= min_coverage))
    table, out_counts, n_unique = _dense_prefix(
        valid, run_keys, counts, capacity, "count_merge")
    return dict(table=table, counts=out_counts, n_unique=n_unique,
                overflow=n_runs > capacity)


def filter_table(t: dict, min_coverage) -> dict:
    """Apply the final coverage threshold to a complete counted table."""
    cap = t["table"].shape[0]
    ridx = torch.arange(cap, device=t["table"].device)
    valid = (ridx < t["n_unique"]) & (t["counts"] >= min_coverage)
    table, counts, n_unique = _dense_prefix(
        valid, t["table"], t["counts"], cap, "count_merge")
    return dict(table=table, counts=counts, n_unique=n_unique,
                overflow=t["overflow"])


def merge_tables(a: dict, b: dict, min_coverage, capacity: int) -> dict:
    """Merge two counted tables (partial counts are summed). Slots at or
    beyond n_unique are masked to SENTINEL before merging."""
    def masked(t):
        v = torch.arange(t["table"].shape[0], device=t["table"].device) \
            < t["n_unique"]
        return (torch.where(v, t["table"], SENTINEL),
                torch.where(v, t["counts"], 0))

    ak, aw = masked(a)
    bk, bw = masked(b)
    return count_weighted(torch.cat([ak, bk]), torch.cat([aw, bw]),
                          min_coverage, capacity)
