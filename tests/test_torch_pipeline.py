"""The port's reads -> contigs pipeline and CLI against the JAX package's
run_pipeline and the golden NumPy oracle (contig sets equal exactly)."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _fixture_codes
from genome_tpu.assemble.pipeline import run_pipeline as jax_run_pipeline
from genome_tpu.golden import assemble_golden
from genome_tpu.io.benchdata import codes_to_reads
from genome_tpu_torch.assemble import cli
from genome_tpu_torch.assemble.pipeline import run_pipeline
from genome_tpu_torch.io import random_genome, read_fastx, simulate_reads
from genome_tpu_torch.io.simulate import plant_repeats
from genome_tpu_torch.params import AssemblyParams


def _case(name):
    if name == "planted":  # one tip, one bubble, one self-loop node
        codes = _fixture_codes(21)
        return codes_to_reads(codes, codes.shape[0]), AssemblyParams(
            k=21, min_coverage=1)
    if name == "sim3kb":
        return simulate_reads(random_genome(3000, seed=123), read_len=100,
                              coverage=25, error_rate=0.01,
                              seed=7), AssemblyParams(k=21, min_coverage=2)
    genome = plant_repeats(random_genome(6000, seed=11),
                           families=((600, 3), (200, 4)), seed=12)
    return simulate_reads(genome, read_len=100, coverage=25,
                          error_rate=0.01, seed=13), AssemblyParams(
        k=21, min_coverage=2)


@pytest.mark.parametrize("name", ["planted", "sim3kb", "repeats"])
def test_pipeline_matches_jax_and_golden(name):
    reads, params = _case(name)
    got = run_pipeline(reads, params, device="cpu")["contigs"]
    assert got == assemble_golden(reads, params)
    assert got == jax_run_pipeline(reads, params)["contigs"]
    assert got


def test_pipeline_code_matrix_and_streaming_count_agree():
    codes = _fixture_codes(21)
    reads = codes_to_reads(codes, codes.shape[0])
    params = AssemblyParams(k=21, min_coverage=1)
    want = assemble_golden(reads, params)
    assert run_pipeline(codes, params, device="cpu")["contigs"] == want
    # chunked counting + table merges, and a capacity that must retry
    res = run_pipeline(reads, params, device="cpu", max_device_kmers=1000,
                       capacity=256)
    assert res["contigs"] == want


def test_pipeline_circular_genome_matches_golden():
    reads = simulate_reads(random_genome(2000, seed=5), read_len=100,
                           coverage=30, circular=True, seed=8)
    params = AssemblyParams(k=21, min_coverage=2)
    got = run_pipeline(reads, params, device="cpu")["contigs"]
    assert got == assemble_golden(reads, params) and len(got) == 1


def test_cli_on_fastq(tmp_path):
    reads, params = _case("sim3kb")
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    out = tmp_path / "contigs.fasta"
    ck = tmp_path / "ck"
    argv = [str(fq), "-o", str(out), "--device", "cpu", "--quiet", "--fai",
            "--checkpoint-dir", str(ck), "--metrics", str(tmp_path / "m.jsonl")]
    assert cli.main(argv + ["--profile", str(tmp_path / "prof")]) == 0
    want = assemble_golden(reads, params)
    assert read_fastx(out) == want
    assert (tmp_path / "contigs.fasta.fai").exists()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    out.unlink()
    assert cli.main(argv + ["--resume"]) == 0  # resumes both phases
    assert read_fastx(out) == want
    assert '"resume"' in (tmp_path / "m.jsonl").read_text()
    assert cli.main([str(fq), "--k", "20", "--device", "cpu"]) == 2


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    reads, params = _case("planted")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(reads, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(reads, params, device="cuda")


def test_unported_counter_raises():
    reads, params = _case("planted")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run_pipeline(reads, params, device="cpu", counter="bucket")


def test_count_phase_reports_windows():
    codes = _fixture_codes(21)
    res = run_pipeline(codes, AssemblyParams(k=21, min_coverage=1),
                       device="cpu")
    assert res["stats"]["n_windows"] == codes.shape[0] * (codes.shape[1] - 20)
    assert res["stats"]["n_contigs"] == len(res["contigs"])
    assert np.all([len(c) >= 21 for c in res["contigs"]])
