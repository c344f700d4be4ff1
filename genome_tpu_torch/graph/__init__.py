"""de Bruijn graph build, simplification and contig emission (torch)."""

from genome_tpu_torch.graph.build import build_graph_device
from genome_tpu_torch.graph.contigs import emit_contigs
from genome_tpu_torch.graph.simplify import simplify_device

__all__ = ["build_graph_device", "simplify_device", "emit_contigs"]
