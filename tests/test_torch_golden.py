"""The port's golden oracles (genome_tpu_torch.golden) against the JAX
package's: assemble_golden and assemble_tiny on every case of
tests/test_golden.py, count_canonical_kmers with and without its chunked
merge, and the CLI's --backend golden FASTA, byte for byte."""

import dataclasses

import numpy as np
import pytest

from genome_tpu import golden as jgolden
from genome_tpu.assemble import cli as jcli
from genome_tpu_torch import golden
from genome_tpu_torch.assemble import cli
from genome_tpu_torch.params import AssemblyParams

from tests.test_golden import CASES, _case
from tests.torch_cpu import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("oracle", ["assemble_golden", "assemble_tiny"])
@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_oracles_match_jax(oracle, case):
    _, reads, params = _case(*case)
    p = AssemblyParams(**dataclasses.asdict(params))
    got = getattr(golden, oracle)(reads, p)
    assert got == getattr(jgolden, oracle)(reads, params)
    assert got == golden.assemble_golden(reads, p)


@pytest.mark.parametrize("chunk_kmers", [1 << 24, 1000])
def test_count_canonical_kmers_matches_jax(chunk_kmers):
    _, reads, params = _case(2, 2000, 80, 10, 0.01, False, 15, 1)
    got = golden.count_canonical_kmers(reads, params.k, 2,
                                       chunk_kmers=chunk_kmers)
    want = jgolden.count_canonical_kmers(reads, params.k, 2,
                                         chunk_kmers=chunk_kmers)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[0].size > 100


def test_cli_backend_golden_matches_jax(tmp_path):
    """--backend golden reads with the Python parser and needs no card:
    the FASTA equals JAX's CLI's, byte for byte, and the metrics hold
    JAX's assemble_golden phase with its contig count."""
    import json
    _, reads, _ = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    fq = tmp_path / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    out, jout = tmp_path / "port.fasta", tmp_path / "jax.fasta"
    metrics = tmp_path / "m.jsonl"
    flags = ["--k", "15", "--backend", "golden", "--quiet"]
    assert cli.main([str(fq), "-o", str(out), "--metrics", str(metrics)]
                    + flags) == 0
    assert jcli.main([str(fq), "-o", str(jout)] + flags) == 0
    assert out.read_bytes() == jout.read_bytes() and out.stat().st_size
    ev = [json.loads(line) for line in metrics.read_text().splitlines()]
    end = next(e for e in ev if e["event"] == "phase_end"
               and e["phase"] == "assemble_golden")
    assert end["n_contigs"] == out.read_text().count(">")
