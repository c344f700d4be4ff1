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
- the host orders the blocks by (head, block) and decodes them.

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

import numpy as np
import torch
import torch.distributed as dist

from genome_tpu_torch.assemble.metrics import count
from genome_tpu_torch.dist.count import EMPTY32, route_buckets
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import (all_any_each, all_gather_rows,
                                        group_device)
from genome_tpu_torch.dist.simplify import _cols
from genome_tpu_torch.io.fastx import write_fasta
from genome_tpu_torch.kernels.compact import compact_flagged
from genome_tpu_torch.kernels.keys import fmix32, mul32
from genome_tpu_torch.utils import dna

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
    head-ordered contig set is decoded and returned (the parallel write,
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

    # every rank's fixed-capacity outputs, in one all_gather
    words, bhead, bblk, bcnt, n_blocks, hid, hh, hl, n_heads, _ = out
    parts = (words, bhead, bblk, bcnt, hid, hh, hl,
             torch.stack([n_blocks, n_heads]).to(I32))
    flat = all_gather_rows(torch.cat(parts), group).cpu().numpy()
    flat = flat.reshape(S, -1)
    cuts = np.cumsum([0] + [p.numel() for p in parts])
    (words, bhead, bblk, bcnt, hid, hh, hl, counts) = (
        flat[:, a:b] for a, b in zip(cuts[:-1], cuts[1:]))
    words = words.view(np.uint32)

    heads_all, blks_all, cnts_all, codes_all = [], [], [], []
    for s in range(S):
        nb = int(counts[s, 0])
        if nb == 0:
            continue
        heads_all.append(bhead[s, :nb])
        blks_all.append(bblk[s, :nb])
        cnts_all.append(bcnt[s, :nb])
        w = words[s, : nb * (BLOCK // 16)]
        c = (w[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
        codes_all.append(c.astype(np.uint8).reshape(nb, BLOCK))
    if not heads_all:
        return [], True
    bh = np.concatenate(heads_all)
    bb = np.concatenate(blks_all)
    bc = np.concatenate(cnts_all)
    bcodes = np.concatenate(codes_all, axis=0)
    order = np.lexsort((bb, bh))
    bh, bc, bcodes = bh[order], bc[order], bcodes[order]

    # the head k-mer join table: sorted ids, searched
    kid = np.concatenate([hid[s, : int(counts[s, 1])] for s in range(S)])
    kkm = np.concatenate([
        (hh[s, : int(counts[s, 1])].astype(np.int64) << 32)
        | hl[s, : int(counts[s, 1])].view(np.uint32).astype(np.int64)
        for s in range(S)])
    korder = np.argsort(kid, kind="stable")
    kid, kkm = kid[korder], kkm[korder]

    starts = np.flatnonzero(np.concatenate([[True], bh[1:] != bh[:-1]]))
    ends = np.concatenate([starts[1:], [bh.size]])
    # every block chain's head must have a head record (searchsorted
    # returns an insertion point, not membership). Checked on the global
    # head set before any local_slice: every rank holds the same (kid,
    # bh) and takes the same decision, or one rank raises while the
    # others wait in write_fasta_parallel's gather.
    pos_all = np.searchsorted(kid, bh[starts])
    if pos_all.size and (int(pos_all.max()) >= kid.size
                         or not (kid[pos_all] == bh[starts]).all()):
        raise AssertionError(
            "dist emit: a contig head id is missing from the head k-mer "
            "join table (the head and block exchanges disagree)")
    if local_slice is not None:
        # this rank's contiguous contig range: a contig's blocks are
        # contiguous after the (head, block) sort
        pid, nproc = local_slice
        n_c = starts.size
        per = -(-n_c // nproc)
        ci0, ci1 = min(pid * per, n_c), min((pid + 1) * per, n_c)
        if ci0 >= ci1:
            return [], True
        blk0 = int(starts[ci0])
        blk1 = int(starts[ci1]) if ci1 < n_c else bh.size
        starts = starts[ci0:ci1] - blk0
        ends = ends[ci0:ci1] - blk0
        bc = bc[blk0:blk1]
        bcodes = bcodes[blk0:blk1]
        pos_all = pos_all[ci0:ci1]
    # one base stream in (head, block) order, each block's filled prefix,
    # decoded to text once; each contig is a slice of it
    valid = np.arange(BLOCK, dtype=np.int32)[None, :] < bc[:, None]
    flat = bcodes[valid]
    cum = np.concatenate([[0], np.cumsum(bc)])
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[flat].tobytes().decode(
        "ascii")
    head_km = kkm[pos_all]
    out: list[str] = []
    for i in range(starts.size):
        a, b = starts[i], ends[i]
        seq = dna.kmer_to_str(int(head_km[i]), k) + text[cum[a] + 1 : cum[b]]
        c = min(seq, dna.revcomp_str(seq))
        if len(c) >= min_contig_len:
            out.append(c)
    return sorted(out), True


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
