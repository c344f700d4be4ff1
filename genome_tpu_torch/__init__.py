"""genome_tpu_torch — the PyTorch/CUDA port of genome_tpu for NVIDIA Hopper.

Same layers and module names as ``genome_tpu`` (the JAX reference, which
this package never imports):

  io/       FASTA/FASTQ streaming, benchmark workloads (host)
  kernels/  int64 k-mer keys, extraction, counting, and the hand-written
            CUDA kernels of kernels/csrc; the stream compactor
            (compact.cu) is one decoupled look-back pass a call
  graph/    de Bruijn graph build, simplification, contig emission
  assemble/ pipeline, CLI, checkpointing, metrics
  dist/     the hash-sharded path over torch.distributed (one process a
            rank): count, build, simplify, final state, emission, the
            multi-process entry
  golden/   the NumPy and pure-Python oracles (host; no torch), the
            contigs every other path must reproduce

One int64 per k-mer (k odd, <= 31, so keys are below 2^62) replaces the
JAX package's (hi, lo) uint32 pair; INT64_MAX is the invalid-window
sentinel. Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no card they raise instead of falling back.
"""

from genome_tpu_torch.params import AssemblyParams

__version__ = "0.1.0"

__all__ = ["AssemblyParams", "__version__"]
