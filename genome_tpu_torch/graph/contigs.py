"""Contig emission: chain state -> canonical contig strings (SEMANTICS §6).

Port of genome_tpu/graph/contigs.py. Two paths with identical output:
- emit_contigs: pulls the per-node chain state to the host (NumPy); the
  reference the tests hold the device path to.
- emit_contigs_device (the pipeline's path): orders the selected nodes on
  the device with one int64 sort on head * n2 + dist, compacts the contig
  starts with the stream compactor, packs the per-node last bases 16 per
  int64 word, and moves only that stream plus one (start, head k-mer)
  record per contig to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from genome_tpu_torch.assemble.metrics import count, host_read, span
from genome_tpu_torch.kernels.compact import compact_ids
from genome_tpu_torch.kernels.keys import INT64_MAX
from genome_tpu_torch.utils import dna


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assemble(starts, ends, first_kmers, codes, k: int,
              min_contig_len: int) -> list[str]:
    out: list[str] = []
    for a, b, v in zip(starts, ends, first_kmers):
        seq = dna.kmer_to_str(int(v), k) + dna.decode(codes[a + 1 : b])
        c = min(seq, dna.revcomp_str(seq))
        if len(c) >= min_contig_len:
            out.append(c)
    return sorted(out)


def emit_contigs(final_state, okv, k: int, min_contig_len: int = 0,
                 node_primary: bool = False) -> list[str]:
    """Assemble canonical contig strings from chain state on the host.

    node_primary: `primary` is a per-node flag (each head's flag already
    gathered to every member of its chain: the sharded final state's
    form) instead of a per-head flag read at each node's head.
    Returns the sorted canonical contig list."""
    head = _host(final_state["head"]).astype(np.int64)
    dist = _host(final_state["dist"])
    primary = _host(final_state["primary"])
    alive_o = _host(final_state["alive_o"])
    okv = _host(okv)
    if not node_primary:
        primary = primary[np.clip(head, 0, None)]
    sel = alive_o & (head >= 0) & primary
    if not sel.any():
        return []
    vh, vd, vv = head[sel], dist[sel], okv[sel]
    order = np.lexsort((vd, vh))
    vh, vv = vh[order], vv[order]
    starts = np.flatnonzero(np.concatenate([[True], vh[1:] != vh[:-1]]))
    ends = np.concatenate([starts[1:], [vh.size]])
    last = (vv & 3).astype(np.uint8)
    return _assemble(starts, ends, vv[starts], last, k, min_contig_len)


def _chain_order_device(head, dist, primary, alive_o, okv,
                        node_primary: bool):
    """Device side of emit_contigs_device. Returns (words [ceil(n2/16)]
    int64 holding 16 packed bases each, in chain order; the sorted head of
    each slot; the contig-start flags; n_sel)."""
    n2 = head.shape[0]
    dev = head.device
    if not node_primary:
        primary = primary[head.clamp(min=0)]
    sel = alive_o & (head >= 0) & primary
    # node ids are int32, so head, dist < n2 < 2^31 and the key < 2^62
    key = torch.where(sel, head.to(torch.int64) * n2 + dist, INT64_MAX)
    ks, order = torch.sort(key)
    n_sel = sel.sum()
    hs = ks // n2
    first = torch.ones(n2, dtype=torch.bool, device=dev)
    first[1:] = hs[1:] != hs[:-1]
    first &= torch.arange(n2, device=dev) < n_sel
    bases = okv[order] & 3
    bases = torch.cat([bases, bases.new_zeros(-n2 % 16)])
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=dev)
    words = (bases.reshape(-1, 16) << shifts).sum(dim=1)
    return words, hs, first, n_sel


def emit_contigs_device(final_state, okv, k: int, min_contig_len: int = 0,
                        node_primary: bool = False,
                        contig_cap: int | None = None) -> list[str]:
    """emit_contigs with the ordering, start compaction and base packing
    done on the device; identical output.

    node_primary: as emit_contigs's.
    contig_cap: size of the contig-start buffer, default max(4096,
    n2 / 64). The compaction's total is exact, so an overflow is redone
    once at exactly the size needed."""
    head = final_state["head"]
    n2 = head.shape[0]
    if n2 == 0:
        return []
    with span("emit.device"):
        words, hs, first, n_sel = _chain_order_device(
            head, final_state["dist"], final_state["primary"],
            final_state["alive_o"], okv, node_primary)
        cap = contig_cap or max(4096, n2 >> 6)
        starts, n_contigs, _ = compact_ids(first, cap, site="contig_starts")
        n_sel, n_contigs = host_read("emit.counts", torch.stack(
            [n_sel, n_contigs]).tolist)
        if n_contigs > cap:
            count("retries")
            starts, _, _ = compact_ids(first, n_contigs, site="contig_starts")
        if n_contigs == 0:
            return []
        starts = starts[:n_contigs]
        first_kmers = okv[hs[starts]]
    with span("emit.copy"):
        words = host_read("emit.bases", lambda: _host(
            words[: -(-n_sel // 16)]))
        meta = host_read("emit.starts", lambda: _host(
            torch.stack([starts, first_kmers])))
    with span("emit.strings"):
        codes = ((words[:, None] >> (2 * np.arange(16, dtype=np.int64)))
                 & 3).astype(np.uint8).reshape(-1)
        starts = meta[0]
        ends = np.concatenate([starts[1:], [n_sel]])
        return _assemble(starts, ends, meta[1], codes, k, min_contig_len)
