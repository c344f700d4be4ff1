"""The benchmark of genome_tpu_torch (see BENCHMARK.json and run.py)."""
