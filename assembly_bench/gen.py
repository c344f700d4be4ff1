"""The benchmark's isolate generator: genome, repeats, haplotypes and reads
from a seed, as one uint8 code matrix per isolate (A=0 C=1 G=2 T=3).

One general generator for every cell: a configuration fixes the genome
(length, repeat families and their divergence), the reads (length,
substitution rate, strand) and the assembly parameters; a cell's traffic
fixes the coverage, the ploidy and heterozygosity, and the number of
isolates. The draws run on `device` from a seeded torch.Generator, a few
large calls each; the matrices are then copied to host memory, where a
user's reads sit. The same (seed, device) gives the same isolates.

Written for the benchmark after the program's io/simulate.py (the same
model: uniform read starts, both strands, substitutions to a different
base, planted near-identical repeat copies, diploid reads half from each
haplotype), which it does not import.
"""

from __future__ import annotations

import numpy as np
import torch


def isolate_seed(seed: int, index: int) -> int:
    """A 63-bit torch seed for isolate `index` of run seed `seed`."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), index])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def n_reads(cfg: dict, cell: dict) -> int:
    return int(cell["coverage"] * cfg["genome_len"] // cfg["read_len"])


def _mutate(x: torch.Tensor, rate: float, g: torch.Generator) -> torch.Tensor:
    """Each code replaced with probability `rate` by a different base."""
    hit = torch.rand(x.shape, generator=g, device=x.device) < rate
    bump = torch.randint(1, 4, x.shape, generator=g, device=x.device,
                         dtype=torch.uint8)
    return torch.where(hit, (x + bump) % 4, x)


def _genome(cfg: dict, g: torch.Generator, dev) -> torch.Tensor:
    G = cfg["genome_len"]
    genome = torch.randint(0, 4, (G,), generator=g, device=dev,
                           dtype=torch.uint8)
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


def _reads(hap: torch.Tensor, n: int, cfg: dict,
           g: torch.Generator) -> torch.Tensor:
    L = cfg["read_len"]
    starts = torch.randint(0, hap.numel() - L + 1, (n,), generator=g,
                           device=hap.device)
    reads = _mutate(hap.unfold(0, L, 1)[starts], cfg["error_rate"], g)
    flip = torch.rand(n, generator=g, device=hap.device) < 0.5
    reads[flip] = 3 - reads[flip].flip(1)
    return reads


def make_isolate(cfg: dict, cell: dict, seed: int, index: int,
                 device="cpu") -> np.ndarray:
    """Isolate `index` of the run: [n_reads, read_len] uint8 codes."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(isolate_seed(seed, index))
    hap = _genome(cfg, g, dev)
    haps = [hap]
    if cell.get("ploidy", 1) == 2:
        haps.append(_mutate(hap, cell["het_rate"], g))
    n = n_reads(cfg, cell)
    share = [n // len(haps) + (i < n % len(haps)) for i in range(len(haps))]
    reads = torch.cat([_reads(h, m, cfg, g) for h, m in zip(haps, share)])
    return reads.cpu().numpy()


def make_isolates(cfg: dict, cell: dict, seed: int,
                  device="cpu") -> list[np.ndarray]:
    return [make_isolate(cfg, cell, seed, i, device)
            for i in range(cell.get("isolates", 2))]
