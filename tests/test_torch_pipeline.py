"""The port's reads -> contigs pipeline and CLI against the JAX package's
run_pipeline and the golden NumPy oracle (contig sets equal exactly)."""

import gzip
import json

import numpy as np
import pytest
import torch

from __graft_entry__ import _fixture_codes
from genome_tpu.assemble.pipeline import run_pipeline as jax_run_pipeline
from genome_tpu.golden import assemble_golden
from genome_tpu.io import fixtures as jax_fixtures
from genome_tpu.io.benchdata import codes_to_reads
from genome_tpu.io.simulate import \
    simulate_reads_diploid as jax_simulate_reads_diploid
from genome_tpu_torch.assemble import cli, pipeline
from genome_tpu_torch.assemble.pipeline import assemble_device, run_pipeline
from genome_tpu_torch.io import (fixtures, random_genome, read_fastx,
                                 simulate_reads)
from genome_tpu_torch.io.simulate import plant_repeats, simulate_reads_diploid
from genome_tpu_torch.kernels.extract import pack_reads
from genome_tpu_torch.params import AssemblyParams

from tests.torch_cpu import one_torch_thread  # noqa: F401


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
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assemble_device(reads, params)


def test_unported_counter_raises():
    reads, params = _case("planted")
    with pytest.raises(ValueError, match="unknown counter"):
        run_pipeline(reads, params, device="cpu", counter="radix")


@pytest.mark.parametrize("counter", ["bucket", "hashtable"])
def test_alternative_counters_give_sort_contigs(counter):
    reads, params = _case("planted")
    want = run_pipeline(reads, params, device="cpu")["contigs"]
    assert want
    assert run_pipeline(reads, params, device="cpu",
                        counter=counter)["contigs"] == want


def test_hashtable_streaming_count_with_retry():
    reads, params = _case("planted")
    want = run_pipeline(reads, params, device="cpu")["contigs"]
    res = run_pipeline(reads, params, device="cpu", counter="hashtable",
                       max_device_kmers=1000, capacity=256)
    assert res["contigs"] == want


def test_count_phase_reports_windows():
    codes = _fixture_codes(21)
    res = run_pipeline(codes, AssemblyParams(k=21, min_coverage=1),
                       device="cpu")
    assert res["stats"]["n_windows"] == codes.shape[0] * (codes.shape[1] - 20)
    assert res["stats"]["n_contigs"] == len(res["contigs"])
    assert np.all([len(c) >= 21 for c in res["contigs"]])


def _fastq_text(reads, start=0):
    return "".join(f"@r{start + i}\n{r}\n+\n{'I' * len(r)}\n"
                   for i, r in enumerate(reads))


@pytest.mark.parametrize("io", ["native", "python"])
def test_cli_io_native_and_python_give_golden(tmp_path, io):
    """Two inputs, one gzipped and of shorter reads (the native matrices
    are padded to the longest record), through each parser."""
    reads, params = _case("sim3kb")
    half = len(reads) // 2
    short = [r[:90] for r in reads[half:]]
    (tmp_path / "a.fastq").write_text(_fastq_text(reads[:half]))
    with gzip.open(tmp_path / "b.fastq.gz", "wt") as f:
        f.write(_fastq_text(short, half))
    out, m = tmp_path / "contigs.fasta", tmp_path / "m.jsonl"
    argv = [str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq.gz"), "-o",
            str(out), "--device", "cpu", "--quiet", "--metrics", str(m)]
    assert cli.main(argv + ["--io", io]) == 0
    assert read_fastx(out) == assemble_golden(reads[:half] + short, params)
    ev = [json.loads(x) for x in m.read_text().splitlines()]
    read_input = next(e for e in ev if e.get("phase") == "read_input"
                      and e["event"] == "phase_end")
    assert read_input["n_reads"] == len(reads)
    assert read_input["total_bp"] == sum(map(len, reads[:half] + short))


@pytest.mark.parametrize("with_n", [False, True])
def test_code_matrix_upload_variants_give_golden(monkeypatch, with_n):
    """A code matrix with no N takes the mask-free upload, one with N's
    the masked one; both give the golden contigs."""
    reads, params = _case("sim3kb")
    codes = pack_reads(reads)
    if with_n:
        rng = np.random.default_rng(5)
        codes[rng.random(codes.shape) < 0.002] = 4
        reads = codes_to_reads(codes, codes.shape[0])
    calls = []
    fn = pipeline.extract_canonical_kmers_packed

    def spy(packed, invalid, *args):
        calls.append(invalid is not None)
        return fn(packed, invalid, *args)
    monkeypatch.setattr(pipeline, "extract_canonical_kmers_packed", spy)
    got = run_pipeline(codes, params, device="cpu")
    assert calls == [with_n]
    assert got["contigs"] == assemble_golden(reads, params)
    assert got["stats"]["n_windows"] == codes.shape[0] * (codes.shape[1] - 20)


@pytest.mark.parametrize("seed", [101, 202, 303, 404, 505, 606])
def test_parity_seed_sweep(seed):
    """The JAX package's content fuzz through the port: random (genome,
    error) draws at k = 15, device == golden on every one."""
    params = AssemblyParams(k=15, min_coverage=2)
    err = (seed % 3) * 0.008  # 0 / 0.8% / 1.6%
    reads = simulate_reads(random_genome(1800, seed=seed), read_len=80,
                           coverage=18, error_rate=err, seed=seed + 7)
    assert assemble_device(reads, params, device="cpu") == \
        assemble_golden(reads, params), (seed, err)


def test_diploid_het_bubbles_match_jax_reads_and_golden():
    """True 50/50 het-SNP bubbles (coverage-tied: popping takes the value
    tie-break, SEMANTICS §5): the port draws JAX's reads and assembles
    the golden contigs."""
    g = random_genome(20_000, seed=51)
    kw = dict(het_rate=0.002, read_len=100, coverage=30, error_rate=0.001,
              seed=52)
    reads = simulate_reads_diploid(g, **kw)
    assert reads == jax_simulate_reads_diploid(g, **kw)
    params = AssemblyParams(k=21, min_coverage=2)
    got = assemble_device(reads, params, device="cpu")
    assert got == assemble_golden(reads, params) and got


@pytest.mark.parametrize("flags", [
    [], ["--repeats"], ["--het", "0.003", "--error-rate", "0.01"],
    ["--circular", "--gc", "0.6", "--read-len", "50"]])
def test_fixtures_cli_writes_jax_bytes(tmp_path, flags):
    argv = ["--genome-len", "8000", "--coverage", "5", "--seed", "3"] + flags
    for mod, tag in ((fixtures, "port"), (jax_fixtures, "jax")):
        assert mod.main(argv + ["-o", str(tmp_path / f"{tag}.fastq"),
                                "--truth", str(tmp_path / f"{tag}.fa")]) == 0
    for ext in ("fastq", "fa"):
        port = (tmp_path / f"port.{ext}").read_bytes()
        assert port and port == (tmp_path / f"jax.{ext}").read_bytes()
    assert read_fastx(tmp_path / "port.fastq")
