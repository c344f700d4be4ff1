from genome_tpu_torch.io.fastx import read_fastx, write_fasta
from genome_tpu_torch.io.simulate import random_genome, simulate_reads

__all__ = ["read_fastx", "write_fasta", "random_genome", "simulate_reads"]
