"""The port's sharded final state and emission (genome_tpu_torch/dist:
make_sharded_final_fast, make_sharded_final, final_state_sharded,
make_sharded_emit, emit_contigs_sharded, write_fasta_parallel) against
the JAX package's, on gloo groups of 1, 2 and 4 ranks started by
run_local: each rank's fast and exact final state and emission outputs,
their exchange ledger entries, the ladder's branch on a circular genome
and under forced overflows, the emission's fallback, local slices and
parallel FASTA write, and assemble_sharded's phases and contigs against
the golden oracle. Every comparison is exact.

The graphs are JAX's sharded count and build (one program each a shard
count: every case at k = 15, streams padded alike), simplified by the
port's replicated passes. One run_local a shard count (module fixture)
computes what every test reads; the JAX references run in this process
meanwhile, each program built once a shard count."""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from genome_tpu.assemble.pipeline import extract_stream as jax_extract_stream
from genome_tpu.dist import simplify as jax_dsimplify
from genome_tpu.dist.assemble import shard_reads as jax_shard_reads
from genome_tpu.dist.build import make_sharded_build
from genome_tpu.dist.count import make_sharded_count
from genome_tpu.dist.emit import BLOCK as JAX_BLOCK
from genome_tpu.dist.emit import make_sharded_emit as jax_make_sharded_emit
from genome_tpu.dist.ledger import LEDGER
from genome_tpu.golden import assemble_golden
from genome_tpu.graph.contigs import emit_contigs as jax_emit_contigs
from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.io import read_fastx as jax_read_fastx
from genome_tpu.kernels.extract import SENTINEL as JAX_SENTINEL
from genome_tpu.params import AssemblyParams as JaxParams
from genome_tpu_torch import convert
from genome_tpu_torch.assemble.pipeline import simplify_with_metrics
from genome_tpu_torch.dist import emit as demit
from genome_tpu_torch.dist import run_local
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.graph.contigs import emit_contigs, emit_contigs_device
from genome_tpu_torch.graph.simplify import final_chain_state
from genome_tpu_torch.io.fastx import write_fasta
from genome_tpu_torch.params import AssemblyParams

from tests import torch_dist_ranks
from tests.torch_cpu import one_torch_thread  # noqa: F401

LOCAL_CAP = 8192
K = 15
# JAX's default phases (genome_tpu/dist/assemble.py:55-170)
JAX_PHASES = ("dist_extract", "dist_count", "dist_build",
              "dist_simplify_sharded", "dist_final_sharded", "dist_contigs")
FALLBACKS = ("dist_simplify_overflow_fallback", "dist_final_fast_fallback",
             "dist_final_overflow_fallback", "dist_emit_overflow_fallback")
COST_KEYS = ("a2a", "psum", "mb_per_shard", "mb_crossing", "dyn_a2a_cap",
             "dyn_mb_cap")
RANKS_MOD = "genome_tpu_torch.dist"


def _graph_cases():
    """Graphs at k = 15 for the final state and emission parity: planted
    exact repeats (several contigs), errors (the passes kill), the
    self-loop cases, and an error-free circular genome (a cycle survives
    simplification: the fast final gives ok = False)."""
    core = random_genome(1800, seed=41)
    rep = core[200:400]
    frag = simulate_reads(core[:600] + rep + core[600:1200] + rep
                          + core[1200:], read_len=70, coverage=15,
                          error_rate=0.0, seed=42)
    errors = simulate_reads(random_genome(2000, seed=3), read_len=80,
                            coverage=20, error_rate=0.01, seed=4)
    island = simulate_reads(random_genome(3000, seed=13) + "A" * 40
                            + random_genome(3000, seed=14), read_len=100,
                            coverage=25, error_rate=0.0, seed=15)
    circ = simulate_reads(random_genome(1200, seed=31), read_len=80,
                          coverage=30, error_rate=0.0, circular=True,
                          seed=32)
    return {"frag": (frag, JaxParams(k=K, min_coverage=2)),
            "errors": (errors, JaxParams(k=K, min_coverage=2)),
            "poly": (["N" * 30 + "A" * 30], JaxParams(k=K, min_coverage=1)),
            "island": (island, JaxParams(k=K, min_coverage=2)),
            "circ": (circ, JaxParams(k=K, min_coverage=1))}


def _circular_ladder():
    """tests/test_dist.py::test_sharded_fast_final_cycle_fallback's case."""
    reads = simulate_reads(random_genome(1500, seed=77), read_len=100,
                           coverage=30, error_rate=0.0, circular=True,
                           seed=78)
    return reads, JaxParams(k=21, min_coverage=1)


def _port_params(p: JaxParams) -> AssemblyParams:
    return AssemblyParams(k=p.k, min_coverage=p.min_coverage)


def _jobs(S, cases):
    """assemble_sharded jobs a shard count: (name, reads, params,
    overrides {"module:name": value})."""
    errors = (cases["errors"][0], _port_params(cases["errors"][1]))
    unreachable = {f"{RANKS_MOD}.assemble:{n}":
                   torch_dist_ranks.replicated_unreachable
                   for n in ("emit_contigs_device", "final_chain_state")}
    jobs = [("errors", *errors, unreachable)]
    if S == 2:
        jobs += [
            ("fast_overflow", *errors, {
                f"{RANKS_MOD}.simplify:make_sharded_final_fast":
                torch_dist_ranks.starved_final_fast}),
            ("emit_guard", *errors, {f"{RANKS_MOD}.emit:_ID_LIMIT": 0}),
            ("emit_tiny", *errors, {f"{RANKS_MOD}.emit:_emit_caps":
                                    torch_dist_ranks.tiny_emit_caps})]
    if S == 4:
        reads, p = _circular_ladder()
        jobs.append(("circular", reads, _port_params(p), {}))
    return jobs


def _padded_streams(S, cases):
    """Every case's JAX per-shard window streams, padded to one row
    length (so that one count program serves them all)."""
    parts = {name: [tuple(map(np.asarray, jax_extract_stream(c, K)))
                    for c in jax_shard_reads(reads, S)]
             for name, (reads, _) in cases.items()}
    m = max(8, max(p[0].size for ps in parts.values() for p in ps))
    out = {}
    for name, ps in parts.items():
        ghi = np.full((S, m), JAX_SENTINEL, dtype=np.uint32)
        glo = ghi.copy()
        for r, (h, l) in enumerate(ps):
            ghi[r, : h.size] = h
            glo[r, : l.size] = l
        out[name] = (ghi.reshape(-1), glo.reshape(-1))
    return out, m


def _valid(n_uni):
    return (np.arange(LOCAL_CAP)[None, :] < np.asarray(n_uni)[:, None]
            ).reshape(-1)


def _graphs(S, cases):
    """JAX's sharded graph of each case, and the port's replicated
    passes' alive mask on it."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    streams, m = _padded_streams(S, cases)
    counter = make_sharded_count(mesh, "shard", m + 64, LOCAL_CAP)
    builder = make_sharded_build(mesh, "shard", K, LOCAL_CAP, 8 * LOCAL_CAP)
    out = {}
    for name, (reads, params) in cases.items():
        th, tl, cnts, n_uni, ovf = counter(
            *streams[name], jnp.asarray([params.min_coverage], jnp.uint32))
        succ, okv_hi, okv_lo, bovf = builder(th, tl, n_uni)
        assert not np.asarray(ovf).any() and not np.asarray(bovf).any()
        succ, okv_hi, okv_lo, cnts, n_uni = (
            np.asarray(x) for x in (succ, okv_hi, okv_lo, cnts, n_uni))
        succ_t, okv = convert.graph_from_jax(succ, okv_hi, okv_lo, "cpu")
        counts = torch.from_numpy(cnts.astype(np.int32))
        valid = torch.from_numpy(_valid(n_uni))
        alive = simplify_with_metrics(succ_t, okv, counts,
                                      torch.ones_like(valid), valid,
                                      _port_params(params))
        fs = final_chain_state(succ_t, okv, counts, alive, valid)
        out[name] = dict(succ=succ, okv_hi=okv_hi, okv_lo=okv_lo,
                         cnts=cnts, n_uni=n_uni, okv=okv.numpy(),
                         alive=alive.numpy(),
                         replicated={k: v.numpy() for k, v in fs.items()})
    return out


def _rank_parts(g, S):
    """A graph as the ranks take it: (succ, okv, counts, n_unique, alive)
    a rank."""
    return list(zip(np.split(g["succ"], S), np.split(g["okv"], S),
                    np.split(g["cnts"].astype(np.int32), S),
                    [int(n) for n in g["n_uni"]], np.split(g["alive"], S)))


def _jax_refs(S, graphs):
    """JAX's fast and exact final state and emission on each graph (each
    program built once), and their ledger entries."""
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    fast = jax_dsimplify.make_sharded_final_fast(mesh, "shard", LOCAL_CAP)
    exact = jax_dsimplify.make_sharded_final(mesh, "shard", LOCAL_CAP)
    ecap, block_cap, head_cap = demit._emit_caps(2 * LOCAL_CAP, S)
    emit = jax_make_sharded_emit(mesh, "shard", LOCAL_CAP, ecap, block_cap,
                                 head_cap)
    out = {}
    for name, g in graphs.items():
        args = (g["succ"], g["okv_hi"], g["okv_lo"], g["cnts"], g["alive"],
                g["n_uni"])
        f = [np.asarray(x) for x in fast(*args)]
        e = exact(*args)
        em = [np.asarray(x) for x in emit(*e[:4], g["okv_hi"], g["okv_lo"])]
        out[name] = dict(fast=f, exact=[np.asarray(x) for x in e], emit=em)
    cross = (S - 1) / S
    out["_ledger"] = {n: LEDGER.programs[n].as_dict(cross)
                      for n in ("dist_final_fast", "dist_final_exact",
                                "dist_emit")}
    out["_exact_bytes"] = LEDGER.programs["dist_final_exact"].elems * 4
    out["_emit_caps"] = (ecap, block_cap, head_cap)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per shard count: the graphs, the port's per-rank results, JAX's
    references; the golden contigs of every read set."""
    fasta_dir = str(tmp_path_factory.mktemp("fasta"))
    cases = _graph_cases()
    t0 = time.perf_counter()
    graphs, port, refs = {1: {}}, {}, {}
    with ThreadPoolExecutor(1) as pool:  # one rank group at a time
        port[1] = pool.submit(
            run_local, torch_dist_ranks.final_parity, 1, device="cpu",
            timeout_s=300, args=({}, K, _jobs(1, cases), fasta_dir))
        for S in (2, 4):
            graphs[S] = _graphs(S, cases)
            port[S] = pool.submit(
                run_local, torch_dist_ranks.final_parity, S, device="cpu",
                timeout_s=300,
                args=({name: _rank_parts(g, S)
                       for name, g in graphs[S].items()},
                      K, _jobs(S, cases), fasta_dir))
        for S in (2, 4):
            refs[S] = _jax_refs(S, graphs[S])
        golden = {name: assemble_golden(r, p)
                  for name, (r, p) in cases.items()}
        golden["circular"] = assemble_golden(*_circular_ladder())
        port = {S: f.result() for S, f in port.items()}
    print(f"ranks and JAX references: {time.perf_counter() - t0:.1f} s")
    return dict(cases=cases, graphs=graphs, port=port, refs=refs,
                golden=golden, fasta_dir=fasta_dir)


def _ranks(runs, S, name):
    return [r["graphs"][name] for r in runs["port"][S]]


def _cat(runs, S, name, part, i):
    """Output i of `part` ("fast", "exact") over every rank, in rank
    order: the JAX global array's layout."""
    return np.concatenate([r[part][i] for r in _ranks(runs, S, name)])


GRAPHS = ("frag", "errors", "poly", "island", "circ")


# ---- the final state ----

@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_fast_final_matches_jax(runs, S, name):
    """make_sharded_final_fast: head, dist, primary_node, alive_o, ok,
    ovf and the observed rounds equal JAX's, on every graph (the
    self-loop and circular ones included: ok = False there)."""
    want = runs["refs"][S][name]["fast"]
    for i in range(4):
        assert np.array_equal(_cat(runs, S, name, "fast", i), want[i]), i
    for r, res in enumerate(_ranks(runs, S, name)):
        assert bool(res["fast"][4]) == bool(want[4][r])  # ok
        assert bool(res["fast"][5]) == bool(want[5][r]) is False  # ovf
        assert tuple(res["rounds"]) == tuple(want[6][r])
    # a self-loop node and a circular genome leave a cycle
    assert bool(want[4].all()) is (name not in ("poly", "circ"))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", ["frag", "errors", "island"])
def test_fast_final_matches_replicated(runs, S, name):
    """Where the fast final is ok, it equals the port's replicated
    final_chain_state on the alive slots: head, dist, and each head's
    primary flag taken per node."""
    rep = runs["graphs"][S][name]["replicated"]
    alive_o = _cat(runs, S, name, "fast", 3)
    head = _cat(runs, S, name, "fast", 0)
    assert alive_o.any()
    assert np.array_equal(rep["alive_o"], alive_o)
    assert np.array_equal(head[alive_o], rep["head"][alive_o])
    assert np.array_equal(_cat(runs, S, name, "fast", 1)[alive_o],
                          rep["dist"][alive_o])
    assert np.array_equal(_cat(runs, S, name, "fast", 2)[alive_o],
                          rep["primary"][head[alive_o]])


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_exact_final_matches_jax(runs, S, name):
    """make_sharded_final (the uncapped chain state: cycles broken at
    their minimum okv): head, dist, primary_node, alive_o and ovf equal
    JAX's, on the self-loop and circular graphs too, and it agrees with
    the fast final wherever that is ok."""
    want = runs["refs"][S][name]["exact"]
    for i in range(4):
        got = _cat(runs, S, name, "exact", i)
        assert np.array_equal(got, want[i]), i
        if bool(runs["refs"][S][name]["fast"][4].all()):
            assert np.array_equal(got, _cat(runs, S, name, "fast", i))
    assert [bool(r["exact"][4]) for r in _ranks(runs, S, name)] == \
        [bool(x) for x in want[4]] == [False] * S


def test_exact_final_breaks_the_cycle(runs):
    """On the circular graph one chain is left, broken at one head with
    the primary flag on one orientation: its nodes have distances 0 ..
    n - 1 from it."""
    head = _cat(runs, 4, "circ", "exact", 0)
    dist = _cat(runs, 4, "circ", "exact", 1)
    prim = _cat(runs, 4, "circ", "exact", 2)
    heads = np.unique(head[head >= 0])
    assert heads.size == 2  # the cycle and its reverse complement
    sel = prim.astype(bool)
    assert np.unique(head[sel]).size == 1
    assert np.array_equal(np.sort(dist[sel]), np.arange(sel.sum()))


# ---- the emission ----

def _u32(x):
    """32-bit words as their unsigned values (the port's int32 words, JAX's
    uint32 ones)."""
    x = np.asarray(x)
    return (x.view(np.uint32) if x.dtype == np.int32 else x).astype(np.int64)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_emit_matches_jax(runs, S, name):
    """Each rank's make_sharded_emit outputs equal JAX's shard below the
    counts: the filled blocks' words, bhead, bblk, bcnt, n_blocks, hid,
    hh, hl, n_heads; no overflow."""
    want = runs["refs"][S][name]["emit"]
    assert tuple(runs["refs"][S]["_emit_caps"]) == \
        tuple(_ranks(runs, S, name)[0]["emit_caps"])
    per = [w.reshape(S, -1) for w in want]
    for r, res in enumerate(_ranks(runs, S, name)):
        (words, bhead, bblk, bcnt, nb, hid, hh, hl, nh, ovf) = res["emit"]
        nb, nh = int(nb), int(nh)
        assert (nb, nh) == (int(per[4][r, 0]), int(per[8][r, 0]))
        assert not bool(ovf) and not bool(per[9][r, 0])
        nw = nb * JAX_BLOCK // 16
        for got, w, n in ((words, per[0], nw), (bhead, per[1], nb),
                          (bblk, per[2], nb), (bcnt, per[3], nb),
                          (hid, per[5], nh), (hh, per[6], nh),
                          (hl, per[7], nh)):
            assert np.array_equal(_u32(got[:n]), _u32(w[r, :n]))
    if name in ("frag", "errors"):
        assert sum(int(r["emit"][4]) for r in _ranks(runs, S, name)) > 0


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("name", GRAPHS)
def test_emit_contigs_sharded_matches_golden(runs, S, name):
    """emit_contigs_sharded on the exact final state gives the golden
    contigs, the same on every rank."""
    got = [r["contigs"] for r in _ranks(runs, S, name)]
    assert all(r["ok"] for r in _ranks(runs, S, name))
    assert got == [runs["golden"][name]] * S


@pytest.mark.parametrize("S", [2, 4])
def test_buffers_are_local_sized(runs, S):
    """Every per-rank output of the final state is [cl2] and of the
    emission O(S * ecap), O(block_cap) or O(head_cap) words, never
    O(S * cl2); the routed records shrink with S."""
    cl2 = 2 * LOCAL_CAP
    ecap, block_cap, head_cap = runs["refs"][S]["_emit_caps"]
    assert ecap <= 1.35 * (cl2 / 2) / S + 65
    assert block_cap <= S * ecap // JAX_BLOCK + 4096
    for res in _ranks(runs, S, "frag"):
        for x in res["fast"][:4] + res["exact"][:4]:
            assert x.shape == (cl2,)
        allowed = {block_cap * (JAX_BLOCK // 16), block_cap, head_cap}
        for x in res["emit"]:
            assert x.ndim == 0 or x.shape[0] in allowed, x.shape
            assert x.ndim == 0 or x.shape[0] != S * cl2


@pytest.mark.parametrize("S", [2, 4])
def test_local_slice_union_equals_full(runs, S):
    """The union of the local slices, each sorted, equals the whole
    emission for P in (1, 2, 3, n, n + 2), on every rank alike."""
    for res in _ranks(runs, S, "frag"):
        full = res["contigs"]
        assert len(full) >= 3
        assert sorted(res["slices"]) == sorted({1, 2, 3, len(full),
                                                len(full) + 2})
        for P, parts in res["slices"].items():
            assert len(parts) == P and all(ok for _, ok in parts)
            for part, _ in parts:
                assert part == sorted(part)
            assert sorted(c for part, _ in parts for c in part) == full, P


def test_write_fasta_parallel(runs):
    """One rank: byte-identical to write_fasta, .gz included (a real
    gzip that reads back). Two ranks, each writing its local slice: one
    merged file equal to write_fasta of every contig, the shards
    removed."""
    from pathlib import Path
    d = Path(runs["fasta_dir"])
    want = runs["golden"]["errors"]
    assert runs["port"][1][0]["fasta"] == [len(want)] * 2
    write_fasta(d / "ref.fasta", want)
    assert (d / "one.fasta").read_bytes() == (d / "ref.fasta").read_bytes()
    with open(d / "one.fasta.gz", "rb") as f:
        assert f.read(2) == b"\x1f\x8b"
    assert jax_read_fastx(d / "one.fasta.gz") == want
    frag = runs["golden"]["frag"]
    assert [r["fasta"] for r in runs["port"][2]] == [[len(frag)]] * 2
    write_fasta(d / "ref2.fasta", frag)
    assert (d / "two.fasta").read_bytes() == (d / "ref2.fasta").read_bytes()
    assert not list(d.glob("*.shard*"))


def test_emit_node_primary_matches_jax(runs):
    """emit_contigs and emit_contigs_device with node_primary=True equal
    JAX's emit_contigs(..., node_primary=True) on the same node-level
    state (JAX's exact final state, gathered)."""
    for name in ("frag", "errors", "circ"):
        g = runs["graphs"][2][name]
        head, dist, prim, alive_o, _ = runs["refs"][2][name]["exact"]
        fs = dict(head=head, dist=dist, primary=prim, alive_o=alive_o)
        want = jax_emit_contigs(fs, g["okv_hi"], g["okv_lo"], K,
                                node_primary=True)
        assert want == runs["golden"][name]
        okv = torch.from_numpy(g["okv"])
        assert emit_contigs(fs, okv, K, node_primary=True) == want
        tfs = {k: torch.from_numpy(np.array(v)) for k, v in fs.items()}
        assert emit_contigs_device(tfs, okv, K, node_primary=True) == want


# ---- the ledger ----

def _cost(entry):
    return {k: entry[k] for k in COST_KEYS}


@pytest.mark.parametrize("S", [2, 4])
def test_final_and_emit_ledger_matches_jax(runs, S):
    """dist_final_fast and dist_emit equal JAX's entries key for key,
    psum and the round-capped dyn_* included. dist_final_exact equals
    JAX's plus its second head/distance doubling: JAX traces that loop's
    body once for both doublings (jax caches the body's jaxpr), so its
    ledger records none of the second's rounds; the port counts the
    2 * rounds all_to_alls it makes (a route and an answer a round, 3
    int32 columns of S * gcap1 slots)."""
    want = runs["refs"][S]["_ledger"]
    cl2 = 2 * LOCAL_CAP
    rounds = (S * cl2 - 1).bit_length() + 1
    gcap1 = jax_dsimplify._cap_for(cl2, S)
    cross = (S - 1) / S
    nbytes = runs["refs"][S]["_exact_bytes"] + rounds * 12 * S * gcap1
    exact = dict(want["dist_final_exact"], a2a=want["dist_final_exact"][
        "a2a"] + 2 * rounds, mb_per_shard=round(nbytes / 1e6, 3),
        mb_crossing=round(nbytes * cross / 1e6, 3))
    for res in _ranks(runs, S, "frag"):
        got = res["ledger"]
        assert _cost(got["dist_final_fast"]) == want["dist_final_fast"]
        assert _cost(got["dist_emit"]) == want["dist_emit"]
        assert _cost(got["dist_final_exact"]) == exact
        assert want["dist_final_fast"]["psum"] > 0
        assert want["dist_final_fast"]["dyn_a2a_cap"] > 0
        for name in ("dist_final_fast", "dist_final_exact", "dist_emit"):
            assert got[name]["invocations"] == 1


def test_ledger_loop_costs_a_round_at_its_cap():
    """An early-exit loop's first round counts `cap` times, under dyn_*
    too, with its psum; its later rounds, and a call at the same key,
    record nothing."""
    led = ExchangeLedger()
    for _ in range(2):
        led.program("p", 1)
        led.record_a2a(2, 1000)
        with led.loop(13) as round_done:
            for _ in range(3):
                led.record_a2a(2, 500_000)
                led.record_psum()
                round_done()
        led.record_a2a(2, 1000)
        led.invoke("p")
    got = led.summary()["p"]
    assert got == dict(a2a=15, psum=13, mb_per_shard=6.502,
                       mb_crossing=3.251, dyn_a2a_cap=13, dyn_mb_cap=6.5,
                       invocations=2)


# ---- the ladder and assemble_sharded ----

def _assembled(runs, S, name):
    got = [r["assemble"][name] for r in runs["port"][S]]
    assert all(g["contigs"] == got[0]["contigs"] for g in got)
    return got[0]["contigs"], got[0]["events"]


def _phases(events):
    return tuple(e["phase"] for e in events if e["event"] == "phase_end")


def _named(events, name):
    return [e for e in events if e["event"] == name]


@pytest.mark.parametrize("S", [1, 2, 4])
def test_assemble_sharded_default_path(runs, S):
    """The default path is sharded end to end: JAX's phases in JAX's
    order, no fallback, the golden contigs, while the replicated final
    state and emission raise inside the ranks. The passes keep psum and
    dyn_* at 0."""
    contigs, events = _assembled(runs, S, "errors")
    assert contigs == runs["golden"]["errors"] and contigs
    assert _phases(events) == JAX_PHASES
    assert not any(_named(events, f) for f in FALLBACKS)
    rounds = _named(events, "dist_final_fast_rounds")
    assert len(rounds) == 1 and rounds[0]["p1"] > 0 and rounds[0]["p2"] > 0
    ledger = _named(events, "exchange_ledger")[0]
    for name in ("dist_degrees", "dist_tips", "dist_bubbles"):
        assert ledger[name]["psum"] == 0 and ledger[name]["dyn_a2a_cap"] == 0
        assert ledger[name]["dyn_mb_cap"] == 0.0
    assert ledger["dist_final_fast"]["invocations"] == 1
    assert ledger["dist_emit"]["invocations"] == 1
    assert "dist_final_exact" not in ledger


def test_ladder_circular_takes_the_exact_final(runs):
    """A circular genome (1,500 bp, 30x, no errors, k = 21, S = 4): the
    fast final reports ok = False, the fallback is logged, the exact
    final runs once, and there is one contig, the golden one."""
    contigs, events = _assembled(runs, 4, "circular")
    assert contigs == runs["golden"]["circular"] and len(contigs) == 1
    assert len(_named(events, "dist_final_fast_fallback")) == 1
    assert not _named(events, "dist_final_fast_rounds")
    ledger = _named(events, "exchange_ledger")[0]
    assert ledger["dist_final_exact"]["invocations"] == 1
    assert ledger["dist_final_fast"]["invocations"] == 1
    assert _phases(events) == JAX_PHASES


def test_ladder_fast_overflow_retries(runs):
    """64-slot route buckets on the fast final's first rung: it
    overflows there and retries at slack 2.7, and the contigs stay
    golden without a fallback."""
    contigs, events = _assembled(runs, 2, "fast_overflow")
    assert contigs == runs["golden"]["errors"]
    retries = _named(events, "dist_final_fast_overflow_retry")
    assert [e["slack"] for e in retries] == [2.7]
    assert not any(_named(events, f) for f in FALLBACKS)
    ledger = _named(events, "exchange_ledger")[0]
    assert ledger["dist_final_fast"]["retry_epochs"] == 1
    assert ledger["dist_final_fast"]["invocations"] == 1
    assert _phases(events) == JAX_PHASES


@pytest.mark.parametrize("job", ["emit_guard", "emit_tiny"])
def test_emit_fallback(runs, job):
    """The S * cl2 guard stubbed to 0, or emission buffers too small on
    every try: dist_emit_overflow_fallback is logged and the gathered
    node-level state gives the golden contigs."""
    contigs, events = _assembled(runs, 2, job)
    assert contigs == runs["golden"]["errors"]
    assert len(_named(events, "dist_emit_overflow_fallback")) == 1
    assert _phases(events) == JAX_PHASES
    ledger = _named(events, "exchange_ledger")[0]
    if job == "emit_tiny":
        assert ledger["dist_emit"]["retry_epochs"] == 2
    else:
        assert "dist_emit" not in ledger
