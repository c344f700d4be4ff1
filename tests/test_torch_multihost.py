"""The port's multi-process entry (genome_tpu_torch/dist/multihost.py and
dist/launch.py) against the JAX package's: _load_local_shard array for
array; assemble_multihost at P = 1 and 2 on gloo (run_local) against
JAX's assemble_multihost on the 8-device CPU mesh and the golden oracle,
its phase_times keys, out_path, an in-process resume, the forced
ladders' escape; and the launcher as a user runs it, two processes with
--device cpu: the assembly, a crash after dist_build and --resume, and a
resume refused on modified input (tests/test_multihost.py's cases, which
JAX marks slow). Every comparison is exact.

A 600 bp genome, 70 bp reads at 10x, k = 15. One module fixture runs the
gloo groups while the JAX reference runs in this process."""

import json
import os
import subprocess
import sys
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from genome_tpu.dist.launch import _load_local_shard as jax_load_local_shard
from genome_tpu.dist.multihost import \
    assemble_multihost as jax_assemble_multihost
from genome_tpu.golden import assemble_golden
from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.params import AssemblyParams as JaxParams
from genome_tpu_torch.dist import launch, run_local
from genome_tpu_torch.io import read_fastx, write_fasta

from tests import torch_dist_ranks, torch_multihost_ranks
from tests.torch_cpu import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
K = 15
PARAMS = JaxParams(k=K)
# JAX's phase_times keys on the sharded path (genome_tpu/dist/
# multihost.py:135-290); "write" only with out_path
PHASES = ["build", "count", "emit", "exchange_ledger", "extract", "final",
          "simplify"]
BENCH_KEYS = ["metric", "process_id", "num_processes", "local_reads",
              "wall_s", "ingest_s", "reads_per_sec_local",
              "reads_per_sec_total", "phases_s", "n_contigs",
              "exchange_ledger"]
DS = "genome_tpu_torch.dist.simplify"
MH = "genome_tpu_torch.dist.multihost"
# the sharded path must not reach the escape or the emission's fallback
SHARDED_ONLY = {f"{MH}:{n}": torch_multihost_ranks.unreachable
                for n in ("simplify_with_metrics", "final_chain_state",
                          "emit_contigs_device")}
STARVED_SIMPLIFY = {f"{DS}:make_sharded_simplify":
                    torch_multihost_ranks.starved_simplify_all}
# forced ladders: (kwargs, overrides {"module:name": value}); an out_path
# is a file name in the fixture's directory
ESCAPES = {
    "simplify_forbid": ({"forbid_replicated": True}, STARVED_SIMPLIFY),
    "simplify_escape": ({}, STARVED_SIMPLIFY),
    "final_escape": ({"out_path": "final_escape.fasta"}, {
        f"{DS}:make_sharded_final_fast":
        torch_multihost_ranks.starved_final_fast_all,
        f"{DS}:make_sharded_final":
        torch_multihost_ranks.starved_final_exact_all,
        f"{MH}:emit_contigs_sharded": torch_multihost_ranks.unreachable}),
    "emit_fallback": ({"out_path": "emit_fallback.fasta"}, {
        "genome_tpu_torch.dist.emit:_emit_caps":
        torch_dist_ranks.tiny_emit_caps,
        f"{MH}:write_fasta_parallel": torch_multihost_ranks.unreachable}),
}


def _reads():
    return simulate_reads(random_genome(600, seed=70), read_len=70,
                          coverage=10, error_rate=0.01, seed=71)


# a read from elsewhere: two copies of it make one more contig
EXTRA = random_genome(70, seed=99)


def _jobs(S, out_dir):
    """(name, kwargs, overrides) of each call a rank group makes."""
    jobs = [("plain", {}, SHARDED_ONLY),
            ("out", {"out_path": f"{out_dir}/out{S}.fasta"}, SHARDED_ONLY)]
    if S == 2:
        for name, (kwargs, overrides) in ESCAPES.items():
            kwargs = {k: f"{out_dir}/{v}" if k == "out_path" else v
                      for k, v in kwargs.items()}
            jobs.append((name, kwargs, overrides))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port at P = 1 and 2 (gloo) and JAX's assemble_multihost (one
    process, 8 CPU devices, with out_path), the golden contigs."""
    reads = _reads()
    out_dir = tmp_path_factory.mktemp("multihost")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # one rank group at a time
        port = {S: pool.submit(
            run_local, torch_multihost_ranks.multihost, S, device="cpu",
            timeout_s=300,
            args=(reads, K, PARAMS.min_coverage, _jobs(S, out_dir),
                  str(out_dir / f"ckpt{S}"), EXTRA))
            for S in (1, 2)}
        jax_pt = {}
        n = jax_assemble_multihost(reads, PARAMS, forbid_replicated=True,
                                   phase_times=jax_pt,
                                   out_path=str(out_dir / "jax.fasta"))
        golden = assemble_golden(reads, PARAMS)
        changed = assemble_golden(reads + [EXTRA] * 2, PARAMS)
        port = {S: f.result() for S, f in port.items()}
    print(f"ranks and JAX reference: {time.perf_counter() - t0:.1f} s")
    jax_contigs = read_fastx(out_dir / "jax.fasta")
    assert n == len(jax_contigs)
    return dict(port=port, jax=jax_contigs, jax_phases=sorted(jax_pt),
                golden=golden, changed=changed, out_dir=out_dir)


def _ranks(runs, S, name):
    return [r[name] for r in runs["port"][S]]


def _golden_fasta(path, contigs):
    write_fasta(path, contigs)
    return Path(path).read_bytes()


# ---- assemble_multihost on gloo ----

@pytest.mark.parametrize("S", [1, 2])
def test_multihost_matches_jax_and_golden(runs, S):
    """Every rank returns JAX's contigs, which are the golden ones, and
    JAX's phase_times keys."""
    assert runs["jax"] == runs["golden"]
    assert runs["jax_phases"] == sorted(PHASES + ["write"])
    for r in _ranks(runs, S, "plain"):
        assert r["result"] == runs["jax"]
        assert r["phases"] == PHASES
        assert set(r["rounds"]) == {"p1", "p2"}


@pytest.mark.parametrize("S", [1, 2])
def test_multihost_out_path(runs, S):
    """out_path: each rank writes its slice and rank 0 merges them, byte
    for byte write_fasta of the golden contigs; the shards are removed,
    every rank returns the total and the keys gain "write"."""
    d = runs["out_dir"]
    want = _golden_fasta(d / f"ref{S}.fasta", runs["golden"])
    assert (d / f"out{S}.fasta").read_bytes() == want
    assert not list(d.glob(f"out{S}.fasta.shard*"))
    for r in _ranks(runs, S, "out"):
        assert r["result"] == len(runs["golden"])
        assert r["phases"] == sorted(PHASES + ["write"])


@pytest.mark.parametrize("S", [1, 2])
def test_multihost_resume(runs, S):
    """A resumed call skips extract, count, build and simplify and gives
    the same contigs; when rank 0's input changes, its digest no longer
    matches, so no rank resumes and every rank recomputes the new set."""
    for r in _ranks(runs, S, "resume_fresh"):
        assert r["result"] == runs["golden"] and r["phases"] == PHASES
    for r in _ranks(runs, S, "resume_again"):
        assert r["result"] == runs["golden"]
        assert r["phases"] == ["emit", "exchange_ledger", "final"]
    assert runs["changed"] != runs["golden"]
    for r in _ranks(runs, S, "resume_changed"):
        assert r["result"] == runs["changed"] and r["phases"] == PHASES


def test_multihost_forbid_replicated(runs):
    """A used-up simplify ladder with forbid_replicated raises JAX's
    RuntimeError on every rank."""
    for r in _ranks(runs, 2, "simplify_forbid"):
        assert r["result"].startswith("RuntimeError: sharded simplify/final "
                                      "overflowed after all retries")


def test_multihost_simplify_escape(runs):
    """A used-up simplify ladder: every rank gathers the graph and runs
    the single-device passes; golden contigs, no final or emit phase."""
    for r in _ranks(runs, 2, "simplify_escape"):
        assert r["result"] == runs["golden"]
        assert r["phases"] == ["build", "count", "extract", "simplify"]


@pytest.mark.parametrize("job,phases", [
    ("final_escape", ["build", "count", "extract", "final", "simplify"]),
    ("emit_fallback", sorted(PHASES + ["write"]))])
def test_multihost_fallbacks_write_on_rank0(runs, job, phases):
    """A used-up final-state ladder (the escape re-simplifies from an
    all-true mask) and an emission that overflows every try (emitted
    from the gathered final state): rank 0 writes the golden FASTA."""
    d = runs["out_dir"]
    want = _golden_fasta(d / f"ref_{job}.fasta", runs["golden"])
    assert (d / f"{job}.fasta").read_bytes() == want
    assert not list(d.glob(f"{job}.fasta.shard*"))
    for r in _ranks(runs, 2, job):
        assert r["result"] == len(runs["golden"]) and r["phases"] == phases


# ---- _load_local_shard ----

@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
    """A FASTA of 5 reads of 50 bp and a FASTQ of 7 reads of 70 bp (one
    with an N): 12 records, so P = 7 leaves the last shard empty."""
    d = tmp_path_factory.mktemp("shards")
    g = random_genome(400, seed=5)
    fa, fq = d / "a.fasta", d / "b.fastq"
    write_fasta(fa, simulate_reads(g, read_len=50, coverage=0.6, seed=6))
    reads = simulate_reads(g, read_len=70, coverage=1.2, seed=7)
    reads[2] = reads[2][:30] + "N" + reads[2][31:]
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    assert (len(read_fastx(fa)), len(reads)) == (5, 7)
    return [str(fa), str(fq)]


@pytest.mark.parametrize("P", [1, 2, 3, 7])
def test_load_local_shard_matches_jax(shard_files, P):
    got = [launch._load_local_shard(shard_files, pid, P) for pid in range(P)]
    for pid, g in enumerate(got):
        want = jax_load_local_shard(shard_files, pid, P)
        assert g.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(g, want)
    assert sum(g.shape[0] for g in got) == 12
    if P == 7:
        assert got[-1].shape == (0, 1)


# ---- the launcher, two processes on gloo ----

def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")


def _launch(tmp, fq, out, extra=(), env_extra=None, timeout=180.0,
            grace=30.0):
    """Both processes of one launch (a fresh file:// rendezvous, stderr
    to files); returns [(returncode, stderr)]. When a process fails, the
    other gets `grace` seconds to fail too (gloo reports a dead peer),
    then is killed; past `timeout` every process is killed."""
    rdv = tmp / f"rendezvous-{uuid.uuid4().hex}"
    # one thread a rank, tests/torch_cpu.py's policy, which no fixture
    # carries into a child interpreter
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + env.get("PYTHONPATH", "").split(os.pathsep))
    procs, errs = [], []
    for pid in range(2):
        err = tmp / f"{rdv.name}.{pid}.err"
        errs.append(err)
        with open(err, "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "genome_tpu_torch.dist.launch",
                 str(fq), "-o", str(out), "--coordinator", f"file://{rdv}",
                 "--num-processes", "2", "--process-id", str(pid),
                 "--k", str(K), "--device", "cpu", "--forbid-replicated",
                 *extra],
                env=env, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=fh))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + grace)
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
    return [(p.returncode, e.read_text()) for p, e in zip(procs, errs)]


def _ok(results):
    for rc, err in results:
        assert rc == 0, err[-3000:]


def test_launch_two_processes(tmp_path):
    """tests/test_multihost.py:26 on the port: the FASTA byte for byte
    write_fasta of the golden contigs, no shard left; with --bench each
    process appends one record with JAX's keys."""
    reads = _reads()
    fq, out = tmp_path / "reads.fastq", tmp_path / "contigs.fasta"
    _write_fastq(fq, reads)
    bench = tmp_path / "bench.jsonl"
    res = _launch(tmp_path, fq, out, ("--bench", "--bench-out", str(bench)))
    _ok(res)
    golden = assemble_golden(reads, PARAMS)
    assert out.read_bytes() == _golden_fasta(tmp_path / "ref.fasta", golden)
    assert not list(tmp_path.glob("contigs.fasta.shard*"))
    assert f"wrote {len(golden)} contigs" in res[0][1]
    recs = sorted((json.loads(x) for x in bench.read_text().splitlines()),
                  key=lambda r: r["process_id"])
    assert [list(r) for r in recs] == [BENCH_KEYS] * 2
    assert [r["local_reads"] for r in recs] == [-(-len(reads) // 2),
                                                len(reads) // 2]
    for r in recs:
        assert r["num_processes"] == 2 and r["n_contigs"] == len(golden)
        assert sorted(r["phases_s"]) == sorted(set(PHASES + ["write"])
                                               - {"exchange_ledger"})
        assert "final_fast_rounds" in r["exchange_ledger"]


def test_launch_kill_one_process_then_resume(tmp_path):
    """tests/test_multihost.py:70 on the port: process 1 exits after
    saving its build shard (GENOME_TPU_CRASH_AFTER=dist_build:1), the
    survivor dies or is killed; --resume loads count and build from the
    shards (their files untouched) and writes the golden FASTA."""
    reads = simulate_reads(random_genome(600, seed=72), read_len=70,
                           coverage=10, error_rate=0.01, seed=73)
    fq, out = tmp_path / "reads.fastq", tmp_path / "contigs.fasta"
    ck = tmp_path / "ckpt"
    _write_fastq(fq, reads)
    args = ("--checkpoint-dir", str(ck))
    res = _launch(tmp_path, fq, out, args,
                  {"GENOME_TPU_CRASH_AFTER": "dist_build:1"})
    assert res[1][0] == 7, res[1][1][-3000:]
    assert "injected crash after dist_build" in res[1][1]
    assert res[0][0] != 7 and "injected crash" not in res[0][1]
    saved = {}
    for phase in ("dist_count", "dist_build"):
        for shard in (0, 1):
            f = ck / f"{phase}.shard{shard}.npz"
            saved[f] = f.stat().st_mtime_ns
    assert not list(ck.glob("dist_simplify.*"))
    _ok(_launch(tmp_path, fq, out, args + ("--resume",)))
    assert read_fastx(out) == assemble_golden(reads, PARAMS)
    assert {f: f.stat().st_mtime_ns for f in saved} == saved
    assert len(list(ck.glob("dist_simplify.shard*.npz"))) == 2


def test_launch_resume_rejects_modified_input(tmp_path):
    """tests/test_multihost.py:132 on the port: checkpoints of input A
    are not resumed against B (as many reads of the same length, two of
    them replaced by a read from elsewhere, one more contig): the job
    recomputes and writes B's contigs."""
    reads_a = simulate_reads(random_genome(600, seed=80), read_len=70,
                             coverage=10, error_rate=0.0, seed=81)
    reads_b = list(reads_a)
    reads_b[3] = reads_b[4] = EXTRA
    fq, out = tmp_path / "reads.fastq", tmp_path / "contigs.fasta"
    args = ("--checkpoint-dir", str(tmp_path / "ckpt"))
    _write_fastq(fq, reads_a)
    _ok(_launch(tmp_path, fq, out, args))
    assert read_fastx(out) == assemble_golden(reads_a, PARAMS)
    _write_fastq(fq, reads_b)
    _ok(_launch(tmp_path, fq, out, args + ("--resume",)))
    want = assemble_golden(reads_b, PARAMS)
    assert want != assemble_golden(reads_a, PARAMS)
    assert read_fastx(out) == want


def test_launch_cuda_without_card_fails_before_any_group(monkeypatch,
                                                         tmp_path):
    """--device cuda (the default) with no card raises before the group
    is joined (a two-process rendezvous nobody else joins would hang)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fq = tmp_path / "reads.fastq"
    _write_fastq(fq, _reads()[:3])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main([str(fq), "-o", str(tmp_path / "c.fasta"),
                     "--coordinator", f"file://{tmp_path}/rendezvous",
                     "--num-processes", "2", "--process-id", "0"])
    assert not dist.is_initialized()
    assert not (tmp_path / "c.fasta").exists()


# ---- four ranks with Metrics: the benchmark's chr14 configuration, cut
# to 20 kbp ----

# chr14_k31 (assembly_bench/configs) at 20 kbp: its Alu-like family at 10
# copies, its L1-like one at 3 copies of 2 kb; 101 bp reads at 30x, k = 31
CHR14_TINY = dict(genome_len=20000, repeat_families=[[300, 10], [2000, 3]],
                  repeat_divergence=0.002, read_len=101, error_rate=0.002)
DIST_PHASES = {"dist_extract", "dist_count", "dist_build",
               "dist_simplify_sharded", "dist_final_sharded", "dist_contigs"}
FOUR_JOBS = [("plain", SHARDED_ONLY), ("simplify_escape", STARVED_SIMPLIFY)]


@pytest.fixture(scope="module")
def four():
    """assemble_multihost with metrics= on 4 gloo ranks, each rank with
    its contiguous shard of one isolate; the plain reference's contigs."""
    from assembly_bench import gen, reference
    codes = gen.make_isolate(CHR14_TINY, dict(coverage=30, ploidy=1),
                             2**31 + 1401, 0)
    ranks = run_local(torch_multihost_ranks.multihost_metrics, 4,
                      device="cpu", timeout_s=300, args=(codes, 31, FOUR_JOBS))
    want = reference.assemble(codes, 31, 2, device="cpu")
    return dict(ranks=ranks, want=want)


def _phase_ends(events):
    return [e for e in events if e["event"] == "phase_end"]


def _counter(events, name):
    return sum(e.get(name, 0) for e in _phase_ends(events))


@pytest.mark.parametrize("job", [j for j, _ in FOUR_JOBS])
def test_multihost_four_ranks_match_reference(four, job):
    """Every rank returns the plain reference's contigs, on the sharded
    path and through the replicated escape."""
    assert len(four["want"]) > 1
    for r in four["ranks"]:
        assert r[job]["contigs"] == four["want"]


@pytest.mark.parametrize("rank", range(4))
def test_multihost_phases_spans_and_counters(four, rank):
    """The sharded path runs in assemble_sharded's phases; every exchange
    is a dist.exchange span; exchange_bytes is (S - 1)/S of every
    exchange's output buffer and `collectives` every collective call, as
    spied on torch.distributed; no escape."""
    r = four["ranks"][rank]["plain"]
    ev, seen = r["events"], r["seen"]
    assert {e["phase"] for e in _phase_ends(ev)} == DIST_PHASES
    spans = [e for e in ev if e["event"] == "span"
             and e["name"] == "dist.exchange"]
    assert len(spans) == seen["all_to_all_single"] + seen["all_gather"] > 0
    assert all(s["parent"] in DIST_PHASES for s in spans)
    assert _counter(ev, "exchange_bytes") == seen["bytes"] > 0
    assert _counter(ev, "collectives") == (
        seen["all_to_all_single"] + seen["all_gather"] + seen["all_reduce"])
    assert _counter(ev, "syncs") >= seen["all_reduce"]
    assert _counter(ev, "escapes") == 0
    assert _counter(ev, "retries") == 0


def test_multihost_escape_counted(four):
    """A used-up slack ladder: each rank counts one escape and three
    overflowed rungs, and the escape runs in dist_simplify."""
    for r in four["ranks"]:
        ev = r["simplify_escape"]["events"]
        assert _counter(ev, "escapes") == 1
        assert _counter(ev, "retries") == 3
        assert {e["phase"] for e in _phase_ends(ev)} == {
            "dist_extract", "dist_count", "dist_build",
            "dist_simplify_sharded", "dist_simplify", "dist_contigs"}
        assert any(e["event"] == "dist_simplify_overflow_fallback"
                   for e in ev)
