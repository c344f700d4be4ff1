"""Gathered sharded-emission outputs built in process, and the host decode
the device decode (dist/emit.py::contigs_from_gathered) is held to.

`gathered_case` lays chains out as make_sharded_emit's outputs look after
the all_gather, one row a rank: each chain's blocks of BLOCK consecutive
nodes on random ranks, each chain head's k-mer record on a random rank,
every row's entries in random order and garbage past its counts.
`host_decode` is the plain host decode of those rows: unpack, lexsort,
join, one Python loop over the contigs. Imports nothing of JAX."""

from __future__ import annotations

import numpy as np

from genome_tpu_torch.dist.emit import BLOCK
from genome_tpu_torch.utils import dna

_WPB = BLOCK // 16  # 32-bit words a block


def gathered_case(seqs, S: int, k: int, seed: int, drop_head: bool = False):
    """(words, bhead, bblk, bcnt, hid, hh, hl, counts) int32 [S, ...] for
    the chains of `seqs` (each at least k bases: node d's base is seq[d + k
    - 1], the head k-mer seq[:k]). drop_head leaves the first chain's head
    record out."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(1 << 31, len(seqs), replace=False)
    blocks = [[] for _ in range(S)]
    heads = [[] for _ in range(S)]
    for i, (hid, seq) in enumerate(zip(ids, seqs)):
        codes = dna.encode(seq)
        nodes = codes[k - 1:]
        for b in range(-(-nodes.size // BLOCK)):
            blocks[rng.integers(S)].append(
                (hid, b, nodes[b * BLOCK:(b + 1) * BLOCK]))
        if not (drop_head and i == 0):
            heads[rng.integers(S)].append((hid, dna.pack_kmer(codes[:k])))
    block_cap = max(map(len, blocks)) + 3
    head_cap = max(map(len, heads)) + 3
    garbage = rng.integers(-(1 << 31), 1 << 31, size=(S, block_cap * _WPB
                                                       + 3 * block_cap
                                                       + 3 * head_cap))
    cut = np.cumsum([block_cap * _WPB] + [block_cap] * 3 + [head_cap] * 2)
    words, bhead, bblk, bcnt, hid, hh, hl = (
        x.astype(np.int32) for x in np.split(garbage, cut, axis=1))
    counts = np.zeros((S, 2), np.int32)
    for s in range(S):
        rng.shuffle(blocks[s])
        rng.shuffle(heads[s])
        counts[s] = len(blocks[s]), len(heads[s])
        for r, (h, b, nodes) in enumerate(blocks[s]):
            bhead[s, r], bblk[s, r], bcnt[s, r] = h, b, nodes.size
            packed = np.zeros(BLOCK, np.uint64)
            packed[:nodes.size] = nodes
            w = (packed.reshape(_WPB, 16)
                 << (2 * np.arange(16, dtype=np.uint64))).sum(axis=1)
            words[s, r * _WPB:(r + 1) * _WPB] = w.astype(np.uint32).view(
                np.int32)
        for r, (h, km) in enumerate(heads[s]):
            hid[s, r] = h
            hh[s, r] = km >> 32
            lo = km & 0xFFFFFFFF
            hl[s, r] = lo - ((lo >> 31) << 32)
    return words, bhead, bblk, bcnt, hid, hh, hl, counts


def host_decode(words, bhead, bblk, bcnt, hid, hh, hl, counts, k: int,
                min_contig_len: int = 0,
                local_slice: tuple[int, int] | None = None) -> list[str]:
    """The sorted canonical contigs of gathered [S, ...] NumPy rows, decoded
    on the host: every block unpacked to BLOCK codes, the blocks lexsorted
    by (head, block), each contig its head k-mer's string plus its blocks'
    filled prefixes after the first base, min(seq, revcomp(seq)). Raises
    AssertionError where a chain head has no k-mer record (on the global
    set, before local_slice)."""
    S = words.shape[0]
    words = words.view(np.uint32)
    heads_all, blks_all, cnts_all, codes_all = [], [], [], []
    for s in range(S):
        nb = int(counts[s, 0])
        if nb == 0:
            continue
        heads_all.append(bhead[s, :nb])
        blks_all.append(bblk[s, :nb])
        cnts_all.append(bcnt[s, :nb])
        w = words[s, : nb * _WPB]
        c = (w[:, None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
        codes_all.append(c.astype(np.uint8).reshape(nb, BLOCK))
    if not heads_all:
        return []
    bh = np.concatenate(heads_all)
    bb = np.concatenate(blks_all)
    bc = np.concatenate(cnts_all)
    bcodes = np.concatenate(codes_all, axis=0)
    order = np.lexsort((bb, bh))
    bh, bc, bcodes = bh[order], bc[order], bcodes[order]

    kid = np.concatenate([hid[s, : int(counts[s, 1])] for s in range(S)])
    kkm = np.concatenate([
        (hh[s, : int(counts[s, 1])].astype(np.int64) << 32)
        | hl[s, : int(counts[s, 1])].view(np.uint32).astype(np.int64)
        for s in range(S)])
    korder = np.argsort(kid, kind="stable")
    kid, kkm = kid[korder], kkm[korder]

    starts = np.flatnonzero(np.concatenate([[True], bh[1:] != bh[:-1]]))
    ends = np.concatenate([starts[1:], [bh.size]])
    pos_all = np.searchsorted(kid, bh[starts])
    if pos_all.size and (int(pos_all.max()) >= kid.size
                         or not (kid[pos_all] == bh[starts]).all()):
        raise AssertionError("a contig head id is missing from the head "
                             "k-mer join table")
    if local_slice is not None:
        pid, nproc = local_slice
        n_c = starts.size
        per = -(-n_c // nproc)
        ci0, ci1 = min(pid * per, n_c), min((pid + 1) * per, n_c)
        if ci0 >= ci1:
            return []
        blk0 = int(starts[ci0])
        blk1 = int(starts[ci1]) if ci1 < n_c else bh.size
        starts = starts[ci0:ci1] - blk0
        ends = ends[ci0:ci1] - blk0
        bc = bc[blk0:blk1]
        bcodes = bcodes[blk0:blk1]
        pos_all = pos_all[ci0:ci1]
    valid = np.arange(BLOCK, dtype=np.int32)[None, :] < bc[:, None]
    flat = bcodes[valid]
    cum = np.concatenate([[0], np.cumsum(bc)])
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[flat].tobytes().decode(
        "ascii")
    head_km = kkm[pos_all]
    out: list[str] = []
    for i in range(starts.size):
        a, b = starts[i], ends[i]
        seq = dna.kmer_to_str(int(head_km[i]), k) + text[cum[a] + 1: cum[b]]
        c = min(seq, dna.revcomp_str(seq))
        if len(c) >= min_contig_len:
            out.append(c)
    return sorted(out)
