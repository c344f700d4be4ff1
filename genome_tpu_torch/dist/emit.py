"""Sharded contig emission (port of genome_tpu/dist/emit.py; SURVEY.md
§3.4, the final merge step).

The chain state (head, dist, primary, alive_o) stays sharded from the
final state to the contigs:

- every rank turns its selected (primary-orientation) nodes into
  (head, dist, base) records and routes them by a hash of (head,
  dist // BLOCK): BLOCKs of consecutive chain positions, so that one
  giant chain spreads over every rank instead of landing whole on its
  head's owner;
- each owner sorts what it received by (head, dist), packs each block's
  bases 16 a 32-bit word at their in-block offsets, and emits one
  (head, block index, fill count) record a block;
- the chain heads' k-mers (one a contig) ride a second, small routing;
- the gathered blocks are ordered by (head, block) on the device, which
  writes each contig's canonical ASCII bytes; the host only slices and
  sorts (contigs_from_gathered).

The exchanges carry JAX's 32-bit words (int32 columns here), so the
`dist_emit` ledger entry's bytes equal JAX's. Where JAX's processes read
the global outputs (`process_allgather`), the ranks all-gather their
fixed-capacity outputs: O(global / S) + slack a rank, as there. No rank
holds the global chain state. The two compactions (the block metadata
and the head records) are the compact_flagged kernel at the sites
`dist_emit_blocks` and `dist_emit_heads`: the host reads only below
their totals. The contigs equal graph/contigs.py's.
"""

from __future__ import annotations

import heapq
import os

import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import count, host_read, span
from genome_tpu_torch.dist.count import EMPTY32, route_buckets
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import (all_any_each, all_gather_rows,
                                        group_device)
from genome_tpu_torch.dist.simplify import _cols
from genome_tpu_torch.graph.contigs import orient_ascii
from genome_tpu_torch.io.fastx import write_fasta
from genome_tpu_torch.kernels.compact import compact_flagged
from genome_tpu_torch.kernels.keys import INT64_MAX, fmix32, mul32

I32 = torch.int32
I64 = torch.int64

BLOCK = 1024           # chain positions an emission block (% 16 == 0)
_LOG_B = BLOCK.bit_length() - 1
_GOLDEN32 = 0x9E3779B9
# dist << 2 | base must fit a non-negative int32 word: emission takes
# S * cl2 below this, or returns not-ok (the caller's replicated
# fallback). A module name, so that a test may lower it.
_ID_LIMIT = 1 << 29
# tries of the capacity ladder (each doubles every capacity)
_TRIES = 3


def _emit_caps(cl2: int, S: int) -> tuple[int, int, int]:
    """(ecap, block_cap, head_cap) of the first try. A (sender, owner)
    bucket holds ecap records: each rank selects at most cl2 / 2 nodes,
    spread over S owners, so an owner receives S * ecap ~ 1.35 *
    global / S. A module name, so that a test may shrink it."""
    ecap = max(64, int(1.35 * (cl2 // 2) / S) + 64)
    block_cap = max(64, S * ecap // BLOCK + 4096)
    return ecap, block_cap, max(64, block_cap)


def make_sharded_emit(group, local_capacity: int, ecap: int, block_cap: int,
                      head_cap: int, ledger: ExchangeLedger | None = None):
    """The per-rank emission program: (head, dist, primary, alive_o, okv),
    this rank's [cl2] tensors (primary is the node-level flag) ->
    (words [block_cap * BLOCK / 16] int32 packed bases, bhead, bblk, bcnt
    [block_cap] int32 (a block's chain head, its index in the chain, its
    filled positions), n_blocks, hid, hh, hl [head_cap] int32 (a head's id
    and its k-mer's high and low words), n_heads, ovf). The per-block and
    per-head outputs are valid below n_blocks and n_heads; the counts
    and ovf are 0-dim tensors of this rank."""
    S = dist.get_world_size(group)
    hcap_send = max(64, ecap // 4)
    key = (S, local_capacity, ecap, block_cap, head_cap)

    def emit(head, dist_, primary, alive_o, okv):
        if ledger is not None:
            ledger.program("dist_emit", key)
        dev = head.device
        sel = alive_o & (head >= 0) & primary
        hc = head.clamp(min=0).to(I64)
        mix = fmix32(mul32(hc, _GOLDEN32) ^ (dist_ >> _LOG_B).to(I64))
        owner = torch.where(sel, mix % S, S)
        rec2 = (dist_ << 2) | (okv & 3).to(I32)
        (r1, r2), _, ovf = route_buckets((head, rec2), owner, S, ecap, group,
                                         ledger)

        # the owner's side: what it received in (head, dist) order, the
        # empty slots (head EMPTY32) last; each (head, dist) is one node
        s = torch.sort((r1.to(I64) << 32) | r2.to(I64)).values
        s1, s2 = (s >> 32).to(I32), (s & 0xFFFFFFFF).to(I32)
        m = s.shape[0]
        valid = s1 != EMPTY32
        sdist = s2 >> 2
        sblk = sdist >> _LOG_B
        first = valid.clone()
        first[1:] &= (s1[1:] != s1[:-1]) | (sblk[1:] != sblk[:-1])
        brank = torch.cumsum(first, 0, dtype=I32) - 1
        n_valid = valid.sum()

        # per-block metadata (head, block) and each block's first record
        (bhead, bblk), bpos, n_blocks, bovf = compact_flagged(
            first, (s1, sblk), block_cap, site="dist_emit_blocks")
        nb = n_blocks.clamp(max=block_cap)
        slot = torch.arange(block_cap, device=dev)
        nxt = torch.cat([bpos[1:], bpos.new_zeros(1)])
        end = torch.where(slot + 1 < nb, nxt, n_valid)
        bcnt = torch.where(slot < nb, end - bpos, 0).to(I32)

        # the dense base layout block_rank * BLOCK + dist % BLOCK; a
        # record past block_cap goes to a slot of its own past the end
        didx = torch.where(valid & (brank < block_cap),
                           brank.to(I64) * BLOCK + (sdist & (BLOCK - 1)),
                           block_cap * BLOCK + torch.arange(m, device=dev))
        codes = torch.zeros(block_cap * BLOCK + m, dtype=torch.uint8,
                            device=dev)
        codes[didx] = (s2 & 3).to(torch.uint8)
        shifts = 2 * torch.arange(16, dtype=I64, device=dev)
        w = (codes[: block_cap * BLOCK].reshape(-1, 16).to(I64)
             << shifts).sum(dim=1)
        words = torch.where(w >= 1 << 31, w - (1 << 32), w).to(I32)

        # the chain heads' k-mer records, to the owner of block 0
        is_h = sel & (dist_ == 0)
        mix0 = fmix32(mul32(hc, _GOLDEN32))
        owner0 = torch.where(is_h, mix0 % S, S)
        (ghid, glo, ghi), _, o2 = route_buckets(
            tuple(_cols((head, okv))), owner0, S, hcap_send, group, ledger)
        (hid, hl, hh), _, n_heads, o3 = compact_flagged(
            ghid != EMPTY32, (ghid, glo, ghi), head_cap,
            site="dist_emit_heads")
        ovf = ovf | bovf | o2 | o3
        return (words, bhead, bblk, bcnt, n_blocks, hid, hh, hl, n_heads,
                ovf)

    return emit


def emit_contigs_sharded(head, dist_, primary, alive_o, okv, k: int,
                         min_contig_len: int = 0, group=None,
                         ledger: ExchangeLedger | None = None,
                         local_slice: tuple[int, int] | None = None):
    """The sharded emission with its capacity ladder: this rank's part;
    every rank of the group calls it with its [cl2] final state.

    Returns (contigs, ok), the same on every rank: ok is False when
    S * cl2 passes _ID_LIMIT or every try overflowed (the caller then
    emits from the gathered state).

    local_slice=(pid, P): only the pid-th of P contiguous slices of the
    head-ordered contig set is written and returned (the parallel write,
    write_fasta_parallel). The missing-head check runs on the global head
    set first, so every rank takes the same raise-or-continue decision."""
    S = dist.get_world_size(group)
    cl2 = head.shape[0]
    if S * cl2 >= _ID_LIMIT:
        return [], False
    ecap, block_cap, head_cap = _emit_caps(cl2, S)
    for _ in range(_TRIES):
        emit = make_sharded_emit(group, cl2 // 2, ecap, block_cap, head_cap,
                                 ledger)
        out = emit(head, dist_, primary, alive_o, okv)
        if ledger is not None:
            ledger.invoke("dist_emit")
        if not all_any_each([out[-1]], group)[0]:
            break
        count("retries")
        ecap *= 2
        block_cap *= 2
        head_cap *= 2
    else:
        return [], False

    # every rank's fixed-capacity outputs, in one all_gather, kept on the
    # device
    words, bhead, bblk, bcnt, n_blocks, hid, hh, hl, n_heads, _ = out
    parts = (words, bhead, bblk, bcnt, hid, hh, hl,
             torch.stack([n_blocks, n_heads]).to(I32))
    flat = all_gather_rows(torch.cat(parts), group).reshape(S, -1)
    gathered = flat.split([p.numel() for p in parts], dim=1)
    return contigs_from_gathered(*gathered, k, min_contig_len,
                                 local_slice), True


def contigs_from_gathered(words, bhead, bblk, bcnt, hid, hh, hl, counts,
                          k: int, min_contig_len: int = 0,
                          local_slice: tuple[int, int] | None = None
                          ) -> list[str]:
    """The sorted canonical contigs of every rank's gathered emission
    outputs: each argument [S, ...] on one device, row s rank s's words,
    bhead, bblk, bcnt, hid, hh, hl as make_sharded_emit returns them and
    counts[s] = (n_blocks, n_heads).

    On the device: the valid blocks sorted by (head, block), so that a
    chain's blocks are contiguous and all but its last full (a chain's
    dists are 0..n-1); each chain head joined to its k-mer record; each
    contig's canonical bytes written as graph/contigs.py writes them (its
    head k-mer's k bases, then the last base of each node at dist 1..n-1,
    oriented by orient_ascii). One host read brings the contig count, the
    slice's range and base count and the missing-head flag (computed on
    the global head set, so every rank raises or none); two copies bring
    the bytes and the (offsets, lengths, reversed) stack; the host
    decodes, slices and sorts.

    local_slice=(pid, P): bytes only for the pid-th of P contiguous
    slices of the head-ordered contigs.
    Spans `dist_emit.device`, `dist_emit.copy`, `dist_emit.strings`;
    counters `d2h_bytes` (the two copies) and `contigs_reversed` (before
    min_contig_len)."""
    dev = words.device
    S, block_cap = bhead.shape
    with span("dist_emit.device"):
        # the valid blocks in (head, block) order, the rest last
        vb = (torch.arange(block_cap, device=dev) < counts[:, :1]).reshape(-1)
        key = torch.where(vb, (bhead.reshape(-1).to(I64) << 32)
                          | bblk.reshape(-1).to(I64), INT64_MAX)
        ks, border = torch.sort(key)
        n_b = ks.numel()
        valid = ks != INT64_MAX
        sh = ks >> 32
        first = valid.clone()
        first[1:] &= sh[1:] != sh[:-1]
        cid_b = torch.cumsum(first, 0) - 1
        n_c = first.sum()
        # per contig (n_b slots, the first n_c used; slot n_b takes the
        # rest): its first sorted block, its node count and its nodes'
        # start in contig order
        cfb = torch.zeros(n_b + 1, dtype=I64, device=dev)
        cfb[torch.where(first, cid_b, n_b)] = torch.arange(n_b, device=dev)
        cn = torch.zeros(n_b + 1, dtype=I64, device=dev).index_add_(
            0, torch.where(valid, cid_b, n_b),
            torch.where(valid, bcnt.reshape(-1)[border].to(I64), 0))
        cnode0 = torch.cat([cn.new_zeros(1), torch.cumsum(cn[:n_b], 0)])
        # each chain head's k-mer record (ids sorted, searched)
        vh = (torch.arange(hid.shape[1], device=dev)
              < counts[:, 1:]).reshape(-1)
        hks, horder = torch.sort(
            torch.where(vh, hid.reshape(-1).to(I64), INT64_MAX), stable=True)
        chead = sh[cfb[:n_b]]
        pos = torch.searchsorted(hks, chead).clamp_(max=hks.numel() - 1)
        missing = ((hks[pos] != chead)
                   & (torch.arange(n_b, device=dev) < n_c)).any()
        hkm = ((hh.reshape(-1).to(I64) << 32)
               | (hl.reshape(-1).to(I64) & 0xFFFFFFFF))[horder[pos]]
        # this rank's contig range: P contiguous slices in head order
        if local_slice is None:
            ci = torch.stack([n_c.new_zeros(()), n_c])
        else:
            pid, nproc = local_slice
            per = torch.div(n_c + nproc - 1, nproc, rounding_mode="floor")
            ci = torch.minimum(per * torch.arange(pid, pid + 2, device=dev),
                               n_c)
        nodes = cnode0.index_select(0, ci)
        c0, c1, n0, n1, miss = host_read("dist_emit.counts", torch.cat(
            [ci, nodes, missing.to(I64).reshape(1)]).tolist)
        if miss:
            raise AssertionError(
                "dist emit: a contig head id is missing from the head k-mer "
                "join table (the head and block exchanges disagree)")
        if c0 >= c1:
            return []
        buf, meta = _slice_bytes(words.reshape(-1), border, cfb[c0:c1],
                                 cn[c0:c1], cnode0[c0:c1] - n0, hkm[c0:c1],
                                 n1 - n0, k)
    with span("dist_emit.copy"):
        buf = host_read("dist_emit.bases", lambda: buf.cpu().numpy())
        offs, lens, rev = host_read("dist_emit.meta",
                                    lambda: meta.cpu().numpy())
        count("d2h_bytes", buf.nbytes + 8 * meta.numel())
        count("contigs_reversed", int(rev.sum()))
    with span("dist_emit.strings"):
        text = buf.tobytes().decode("ascii")
        return sorted([text[o:o + n] for o, n in zip(offs.tolist(),
                                                     lens.tolist())
                       if n >= min_contig_len])


def _slice_bytes(words, border, cfb, cn, s, hkm, n_nodes: int, k: int):
    """The canonical ASCII bytes of m contigs: contig i's n_i = cn[i] nodes
    lie in sorted blocks cfb[i], cfb[i] + 1, ... (border maps a sorted
    block to its gathered row: words [row * BLOCK / 16 ...]) and start at
    node s[i] of the slice; hkm[i] is its head k-mer. Contig i's
    L_i = n_i + k - 1 bases lie at offset s_i + i (k - 1): its head
    k-mer's k bases, then the last base of the node at dist j - k + 1.
    Returns orient_ascii's (bytes, meta)."""
    dev = words.device
    m = cn.numel()
    ids = torch.arange(m, device=dev)
    lens = cn + (k - 1)
    offs = s + ids * (k - 1)
    n_out = n_nodes + m * (k - 1)
    cid = torch.repeat_interleave(ids, lens, output_size=n_out)
    j = torch.arange(n_out, device=dev) - offs[cid]
    d = (j - (k - 1)).clamp_(min=0)
    row = border[cfb[cid] + (d >> _LOG_B)]
    w = words[row * (BLOCK // 16) + ((d & (BLOCK - 1)) >> 4)]
    del row
    f = ((w >> (2 * (d & 15))) & 3).to(torch.uint8)
    del w, d
    # the first k bases: the head k-mer's
    t = torch.arange(k, device=dev)
    f[(offs[:, None] + t).reshape(-1)] = (
        (hkm[:, None] >> (2 * (k - 1 - t))) & 3).to(torch.uint8).reshape(-1)
    return orient_ascii(f, offs, lens, cid, j)


def write_fasta_parallel(path: str, local_contigs: list[str],
                         group=None) -> int:
    """Every rank writes its sorted contig slice to `path.shard<rank>`;
    rank 0 then streams a k-way merge of the sorted shards into `path`
    (through io.fastx.write_fasta: the same headers, wrapping and gzip
    for a `.gz` path, byte-identical to write_fasta(path, sorted(all
    contigs))) and removes the shards. The ranks share a file system.
    Two all_gathers of a count are the barriers: before the merge (every
    shard written) and after it (no rank returns before `path` exists).
    Returns the total contig count on every rank."""
    rank, P = dist.get_rank(group), dist.get_world_size(group)
    with open(f"{path}.shard{rank}", "w") as f:
        for c in local_contigs:
            f.write(c + "\n")
    dev = group_device(group)
    counts = all_gather_rows(torch.tensor([len(local_contigs)], device=dev),
                             group)
    total = int(counts.sum())
    if rank == 0:
        files = [open(f"{path}.shard{p}") for p in range(P)]
        try:
            its = [(ln.rstrip("\n") for ln in fh) for fh in files]
            write_fasta(path, heapq.merge(*its))
        finally:
            for p, fh in enumerate(files):
                fh.close()
                os.remove(f"{path}.shard{p}")
    all_gather_rows(torch.zeros(1, dtype=I64, device=dev), group)
    return total
