"""The benchmark's isolate generator: genome, repeats, haplotypes and reads
from a seed, as one uint8 code matrix per isolate (A=0 C=1 G=2 T=3).

One general generator for every cell: a configuration fixes the genome
(length, repeat families and their divergence, whether the chromosome is
circular, and any further molecules), the reads (length, substitution
rate, strand) and the assembly parameters; a cell's traffic fixes the
coverage, the ploidy and heterozygosity, and the number of isolates. The
draws run on `device` from a seeded torch.Generator, a few large calls
each; the matrices are then copied to host memory, where a user's reads
sit. The same (seed, device) gives the same isolates.

A configuration may state, beside the chromosome, `"circular": true`
(read starts uniform over the whole chromosome, bases taken modulo its
length, so reads wrap its origin) and `"replicons"`: a list of further
molecules, each {"name", "length", "circular", "copies"}, such as a
mitochondrion or a plasmid. A replicon's bases are uniform random, with
no repeat planted; it is the same in every haplotype (ploidy and
het_rate are the chromosome's); it gets int(coverage * copies * length
// read_len) reads with the configuration's read length, substitution
rate and strand rule. Its draws come after all of the chromosome's, and
where replicons are stated one row permutation, drawn last, shuffles the
whole matrix, as a flow cell's reads come in no order. A configuration
without either key draws what it drew before they existed.

Written for the benchmark after the program's io/simulate.py (the same
model: uniform read starts, both strands, substitutions to a different
base, planted near-identical repeat copies, diploid reads half from each
haplotype, reads of a circular genome wrapping its origin), which it does
not import.
"""

from __future__ import annotations

import numpy as np
import torch


def isolate_seed(seed: int, index: int) -> int:
    """A 63-bit torch seed for isolate `index` of run seed `seed`."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def read_counts(cfg: dict, cell: dict) -> list[tuple[str, int]]:
    """(molecule, reads) in draw order: the chromosome over all its
    haplotypes, then each replicon."""
    cov, L = cell["coverage"], cfg["read_len"]
    return [("chromosome", int(cov * cfg["genome_len"] // L))] + [
        (r["name"], int(cov * r["copies"] * r["length"] // L))
        for r in cfg.get("replicons", [])]


def n_reads(cfg: dict, cell: dict) -> int:
    return sum(n for _, n in read_counts(cfg, cell))


def _mutate(x: torch.Tensor, rate: float, g: torch.Generator) -> torch.Tensor:
    """Each code replaced with probability `rate` by a different base."""
    hit = torch.rand(x.shape, generator=g, device=x.device) < rate
    bump = torch.randint(1, 4, x.shape, generator=g, device=x.device,
                         dtype=torch.uint8)
    return torch.where(hit, (x + bump) % 4, x)


def _bases(n: int, g: torch.Generator, dev) -> torch.Tensor:
    return torch.randint(0, 4, (n,), generator=g, device=dev,
                         dtype=torch.uint8)


def _genome(cfg: dict, g: torch.Generator, dev) -> torch.Tensor:
    G = cfg["genome_len"]
    genome = _bases(G, g, dev)
    for seg_len, copies in cfg.get("repeat_families", []):
        if seg_len >= G:
            continue
        src, *dsts = torch.randint(0, G - seg_len + 1, (copies + 1,),
                                   generator=g, device=dev).tolist()
        seg = genome[src : src + seg_len].clone()
        for dst in dsts:
            genome[dst : dst + seg_len] = _mutate(
                seg, cfg["repeat_divergence"], g)
    return genome


def _reads(seq: torch.Tensor, n: int, cfg: dict, g: torch.Generator,
           circular: bool = False) -> torch.Tensor:
    """n reads of `seq`; a circular one's start anywhere and wrap."""
    L, G = cfg["read_len"], seq.numel()
    if circular:  # the sequence followed by its first L - 1 bases
        seq = seq.repeat(1 + -(-(L - 1) // G))[: G + L - 1]
    starts = torch.randint(0, seq.numel() - L + 1, (n,), generator=g,
                           device=seq.device)
    reads = _mutate(seq.unfold(0, L, 1)[starts], cfg["error_rate"], g)
    flip = torch.rand(n, generator=g, device=seq.device) < 0.5
    reads[flip] = 3 - reads[flip].flip(1)
    return reads


def _isolate(cfg: dict, cell: dict, seed: int, index: int, device):
    """The isolate's molecules in draw order, each (name, [its bases, one
    a haplotype], circular, its reads), and the row permutation (None
    where no replicon is stated)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(isolate_seed(seed, index))
    hap = _genome(cfg, g, dev)
    haps = [hap]
    if cell.get("ploidy", 1) == 2:
        haps.append(_mutate(hap, cell["het_rate"], g))
    counts = read_counts(cfg, cell)
    n = counts[0][1]
    share = [n // len(haps) + (i < n % len(haps)) for i in range(len(haps))]
    circ = cfg.get("circular", False)
    reads = torch.cat([_reads(h, m, cfg, g, circ)
                       for h, m in zip(haps, share)])
    mols = [("chromosome", haps, circ, reads)]
    for r, (_, m) in zip(cfg.get("replicons", []), counts[1:]):
        seq = _bases(r["length"], g, dev)
        mols.append((r["name"], [seq], r["circular"],
                     _reads(seq, m, cfg, g, r["circular"])))
    perm = torch.randperm(sum(m for _, m in counts), generator=g,
                          device=dev) if len(mols) > 1 else None
    return mols, perm


def make_isolate(cfg: dict, cell: dict, seed: int, index: int,
                 device="cpu") -> np.ndarray:
    """Isolate `index` of the run: [n_reads, read_len] uint8 codes."""
    mols, perm = _isolate(cfg, cell, seed, index, device)
    reads = mols[0][3] if perm is None else \
        torch.cat([m[3] for m in mols])[perm]
    return reads.cpu().numpy()


def make_isolates(cfg: dict, cell: dict, seed: int,
                  device="cpu") -> list[np.ndarray]:
    return [make_isolate(cfg, cell, seed, i, device)
            for i in range(cell.get("isolates", 2))]
