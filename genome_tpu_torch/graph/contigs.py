"""Contig emission: chain state -> canonical contig strings (SEMANTICS §6).

Port of genome_tpu/graph/contigs.py. Two paths with identical output:
- emit_contigs: pulls the per-node chain state to the host (NumPy); the
  reference the tests hold the device path to.
- emit_contigs_device (the pipeline's path): orders the selected nodes on
  the device with one int64 sort on head * n2 + dist, compacts the contig
  starts with the stream compactor, writes every contig's canonical
  sequence as ASCII into one byte buffer, and moves that buffer plus one
  (offset, length, reversed) record per contig to the host, which only
  slices and sorts.
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


def _chain_order_device(head, dist, primary, alive_o, node_primary: bool):
    """Device side of emit_contigs_device, up to the counts. Returns (the
    slot order of the selected nodes, each chain's nodes together by head
    and in chain order; the contig-start flags; n_sel)."""
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
    return order, first, n_sel


# "ACGT" as one little-endian word: byte c is code c's ASCII letter
_ACGT_WORD = int.from_bytes(b"ACGT", "little")


def _canonical_bytes(okv, order, starts, n_sel: int, n_contigs: int, k: int):
    """Each contig's canonical sequence as ASCII, in one byte buffer.

    Contig i holds slots [s_i, e_i) of `order`; its L_i = e_i - s_i + k - 1
    bases lie at offset o_i = s_i + i (k - 1). Base j is base j of the
    first node's k-mer for j < k, else the last base of slot
    s_i + j - k + 1: what _assemble concatenates. orient_ascii writes
    min(seq, revcomp(seq)), as A < C < G < T in codes and in ASCII.
    Returns (bytes [n_out] uint8, meta [3, n_contigs] int64: offsets,
    lengths, reversed)."""
    dev = okv.device
    s = starts[:n_contigs].to(torch.int64)
    ids = torch.arange(n_contigs, device=dev)
    lens = torch.cat([s[1:], s.new_full((1,), n_sel)]) - s + (k - 1)
    offs = s + ids * (k - 1)
    n_out = n_sel + n_contigs * (k - 1)
    cid = torch.repeat_interleave(ids, lens, output_size=n_out)
    j = torch.arange(n_out, device=dev) - offs[cid]
    # base j < k - 1 of the first k-mer, else the last base of its node
    back = (k - 1 - j).clamp_(min=0)
    src = s[cid] + (j - (k - 1)).clamp_(min=0)
    f = ((okv[order[src]] >> (2 * back)) & 3).to(torch.uint8)
    del back, src
    return orient_ascii(f, offs, lens, cid, j)


def orient_ascii(f, offs, lens, cid, j):
    """The orientation and ASCII tail of the canonical-bytes layout: f
    [n_out] uint8 the forward base codes, contig cid[x] holding positions
    [offs, offs + lens) and j[x] = x - offs[cid[x]]. Each contig is written
    reverse-complemented iff, at its first j with f[j] != 3 - f[L-1-j],
    the reverse complement's base is smaller (palindromes stay forward).
    Returns (bytes [n_out] uint8, meta [3, n_contigs] int64: offsets,
    lengths, reversed)."""
    mirror = offs[cid] + lens[cid] - 1 - j
    rc = 3 - f[mirror]
    del mirror
    # first forward/reverse mismatch of each contig (lens: none, a palindrome)
    miss = lens.scatter_reduce(0, cid, torch.where(f != rc, j, lens[cid]),
                               "amin")
    at = offs + torch.minimum(miss, lens - 1)
    rev = (miss < lens) & (rc[at] < f[at])
    out = torch.where(rev[cid], rc, f).to(torch.int32)
    buf = ((_ACGT_WORD >> (out << 3)) & 255).to(torch.uint8)
    return buf, torch.stack([offs, lens, rev.to(torch.int64)])


def emit_contigs_device(final_state, okv, k: int, min_contig_len: int = 0,
                        node_primary: bool = False,
                        contig_cap: int | None = None) -> list[str]:
    """emit_contigs with the ordering, start compaction and each contig's
    canonical orientation done on the device, which writes every contig's
    ASCII bases into one buffer; the host slices and sorts. Identical
    output.

    node_primary: as emit_contigs's.
    contig_cap: size of the contig-start buffer, default max(4096,
    n2 / 64). The compaction's total is exact, so an overflow is redone
    once at exactly the size needed.
    Counters: `d2h_bytes`, the bytes of the two copies; `contigs_reversed`,
    the contigs written reverse-complemented (min_contig_len not yet
    applied)."""
    head = final_state["head"]
    n2 = head.shape[0]
    if n2 == 0:
        return []
    with span("emit.device"):
        order, first, n_sel = _chain_order_device(
            head, final_state["dist"], final_state["primary"],
            final_state["alive_o"], node_primary)
        cap = contig_cap or max(4096, n2 >> 6)
        starts, n_contigs, _ = compact_ids(first, cap, site="contig_starts")
        n_sel, n_contigs = host_read("emit.counts", torch.stack(
            [n_sel, n_contigs]).tolist)
        if n_contigs > cap:
            count("retries")
            starts, _, _ = compact_ids(first, n_contigs, site="contig_starts")
        if n_contigs == 0:
            return []
        buf, meta = _canonical_bytes(okv, order, starts, n_sel, n_contigs, k)
    with span("emit.copy"):
        buf = host_read("emit.bases", lambda: _host(buf))
        offs, lens, rev = host_read("emit.meta", lambda: _host(meta))
        count("d2h_bytes", buf.nbytes + 8 * meta.numel())
        count("contigs_reversed", int(rev.sum()))
    with span("emit.strings"):
        text = buf.tobytes().decode("ascii")
        return sorted([text[o:o + n] for o, n in zip(offs.tolist(),
                                                     lens.tolist())
                       if n >= min_contig_len])
