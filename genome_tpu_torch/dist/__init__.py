"""Hash-sharded path (port of genome_tpu/dist/).

One process per shard: the JAX package's mesh axis becomes a
torch.distributed process group (NCCL on the card, one rank a card; gloo
on the CPU), and the body of each JAX shard_map becomes a plain per-rank
function that every rank of the group calls (SPMD). Each tiled
`lax.all_to_all` on an [S, w] buffer is `all_to_all_single` on the same
[S, w] tensor: row j goes to rank j, row i of the result came from rank
i. Host decisions that JAX took from a gathered array (the overflow
retries, shrink_tables' size) are agreed with an all_reduce MAX, so
every rank takes the same branch.

Ported: partition (owner hash), mesh (group set-up, collectives, the
local launcher run_local), ledger, count, build, the sharded simplify
passes and their host loop, the sharded final state (the exact one and
the ruler-ranking fast one, with final_state_sharded's ladder), the
sharded emission (emit_contigs_sharded, and write_fasta_parallel for
per-rank slices), assemble_sharded, sharded end to end by default, and
the multi-process entry: multihost (initialize, assemble_multihost: each
rank passes its own reads, with per-rank checkpoints and resume) and
launch (python -m genome_tpu_torch.dist.launch, one process a rank).
"""

from genome_tpu_torch.dist.assemble import assemble_sharded, shard_reads
from genome_tpu_torch.dist.emit import (emit_contigs_sharded,
                                        make_sharded_emit,
                                        write_fasta_parallel)
from genome_tpu_torch.dist.mesh import run_local
from genome_tpu_torch.dist.multihost import assemble_multihost, initialize
from genome_tpu_torch.dist.partition import owner_of_np
from genome_tpu_torch.dist.simplify import (final_state_sharded,
                                            make_sharded_final,
                                            make_sharded_final_fast,
                                            make_sharded_simplify,
                                            simplify_sharded)

__all__ = ["assemble_multihost", "assemble_sharded", "emit_contigs_sharded",
           "final_state_sharded", "initialize", "make_sharded_emit",
           "make_sharded_final", "make_sharded_final_fast",
           "make_sharded_simplify", "owner_of_np", "run_local", "shard_reads",
           "simplify_sharded", "write_fasta_parallel"]
