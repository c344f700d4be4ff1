"""Hash-sharded multi-device path (port of genome_tpu/dist/). Only the
owner hash is ported so far (partition.fmix32); see ROADMAP.md."""
