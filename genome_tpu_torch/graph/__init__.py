"""de Bruijn graph build, simplification and contig emission (torch)."""
