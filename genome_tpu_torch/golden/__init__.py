"""The golden oracles (host, NumPy and pure Python): the contig sets the
device pipeline must reproduce exactly (SEMANTICS.md)."""

from genome_tpu_torch.golden.assembler import assemble as assemble_golden
from genome_tpu_torch.golden.assembler import count_canonical_kmers
from genome_tpu_torch.golden.tiny import assemble as assemble_tiny

__all__ = ["assemble_golden", "assemble_tiny", "count_canonical_kmers"]
