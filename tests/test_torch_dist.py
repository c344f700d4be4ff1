"""The port's hash-sharded path (genome_tpu_torch/dist) against the JAX
package's, exactly, on gloo groups of 1, 2 and 4 ranks started by
run_local: the owner hash, each rank's count table and overflow flag,
the build's succ (global ids) and okv and its overflow flag, the sharded
simplify's alive mask on JAX's graph (against JAX simplify_sharded and
the port's replicated passes), remote_gather and seg_route against a
plain gather and segment reduction, the exchange ledger's count, build
and simplify entries, and assemble_sharded's contigs (the sharded and
the replicated simplify, the forced fresh-degree, slack-retry and
fallback paths) against JAX assemble_sharded and the golden oracle.
Every comparison is exact.

One run_local a shard count (module fixture) computes what every test
reads, from the JAX graph of that shard count; the JAX references run in
this process meanwhile."""

import functools
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from genome_tpu.assemble.pipeline import extract_stream as jax_extract_stream
from genome_tpu.dist import assemble_sharded as jax_assemble_sharded
from genome_tpu.dist.assemble import shard_reads as jax_shard_reads
from genome_tpu.dist.build import make_sharded_build
from genome_tpu.dist.count import make_sharded_count
from genome_tpu.assemble.metrics import Metrics as JaxMetrics
from genome_tpu.dist import simplify as jax_dsimplify
from genome_tpu.dist.ledger import LEDGER
from genome_tpu.dist.partition import owner_of_np as jax_owner_of_np
from genome_tpu.golden import assemble_golden
from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.io import random_genome, simulate_reads
from genome_tpu.kernels import u64
from genome_tpu.kernels.extract import SENTINEL as JAX_SENTINEL
from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu.params import AssemblyParams as JaxParams
from genome_tpu_torch import convert
from genome_tpu_torch.assemble.pipeline import simplify_with_metrics
from genome_tpu_torch.dist import (assemble_sharded, owner_of_np, run_local,
                                   shard_reads)
from genome_tpu_torch.dist.ledger import ExchangeLedger
from genome_tpu_torch.dist.mesh import init_group, shard_device
from genome_tpu_torch.dist.partition import owner_of
from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.extract import pack_reads
from genome_tpu_torch.params import AssemblyParams

from tests import torch_dist_ranks
from tests.test_golden import _case
from tests.torch_cpu import one_torch_thread  # noqa: F401

LOCAL_CAP = 8192
SHARDS = (1, 2, 4)
PHASES = ("dist_extract", "dist_count", "dist_build", "dist_simplify",
          "dist_contigs")  # sharded_simplify=False
SHARDED_PHASES = ("dist_extract", "dist_count", "dist_build",
                  "dist_simplify_sharded", "dist_final_sharded",
                  "dist_contigs")
SIMPLIFY_PROGRAMS = ("dist_degrees", "dist_tips", "dist_bubbles")
OPS_SEED = 11


def _port_params(p: JaxParams) -> AssemblyParams:
    return AssemblyParams(k=p.k, min_coverage=p.min_coverage)


def _jax_padded_stream(reads, k, S):
    """JAX's per-shard window streams, padded to one row length m: the
    input of make_sharded_count (as tests/test_dist.py builds it)."""
    parts = [tuple(map(np.asarray, jax_extract_stream(c, k)))
             for c in jax_shard_reads(reads, S)]
    m = max(max(p[0].size for p in parts), 8)
    ghi = np.full((S, m), JAX_SENTINEL, dtype=np.uint32)
    glo = ghi.copy()
    for r, (h, l) in enumerate(parts):
        ghi[r, : h.size] = h
        glo[r, : l.size] = l
    return ghi, glo, m


def _max_bucket(owners_per_rank, S):
    """The fullest (sender, owner) bucket."""
    return max(int(np.bincount(o, minlength=S).max()) if o.size else 0
               for o in owners_per_rank)


def _max_query_bucket(table_keys, k, S):
    """The fullest bucket of the build's extension queries: shard r's
    table is the golden table's keys that r owns."""
    own = owner_of_np(table_keys, S)
    per_rank = []
    for r in range(S):
        t = torch.from_numpy(table_keys[own == r].astype(np.int64))
        okv = torch.stack([t, keys.revcomp(t, k)], 1).reshape(-1)
        ext = torch.cat([((okv << 2) & keys.kmer_mask(k)) | b
                         for b in range(4)])
        per_rank.append(owner_of(keys.canonical(ext, k), S).numpy())
    return _max_bucket(per_rank, S)


def _jax_ledger_entry(name, run):
    LEDGER.reset_invocations()
    out = run()
    LEDGER.invoke(name)
    return out, LEDGER.summary()[name]


def _plan(S, reads, params):
    """JAX's padded input and the caps: a roomy one, the fullest bucket's
    size, and one below it, for the count and for the build."""
    k = params.k
    ghi, glo, m = _jax_padded_stream(reads, k, S)
    valid = ghi != JAX_SENTINEL
    stream = u64.to_u64_np(ghi.reshape(-1), glo.reshape(-1)).reshape(S, m)
    per = _max_bucket([jax_owner_of_np(stream[r][valid[r]], S)
                       for r in range(S)], S)
    want_k, _ = count_canonical_kmers(reads, k, params.min_coverage)
    qper = _max_query_bucket(want_k, k, S)
    return dict(ghi=ghi, glo=glo, pad_to=m, bucket_caps=[m + 64, per, per - 1],
                query_caps=[8 * LOCAL_CAP, qper, qper - 1])


def _reference(S, plan, params):
    """JAX count and build at each cap of the plan, and their ledgers."""
    k, ghi, glo = params.k, plan["ghi"], plan["glo"]
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    min_cov = jnp.asarray([params.min_coverage], jnp.uint32)
    ref = {"count": [], "build": []}
    for cap in plan["bucket_caps"]:
        fn = make_sharded_count(mesh, "shard", cap, LOCAL_CAP)
        out, led = _jax_ledger_entry(
            "dist_count", lambda: fn(ghi.reshape(-1), glo.reshape(-1),
                                     min_cov))
        ref["count"].append(dict(out=[np.asarray(x) for x in out],
                                 ledger=led))
    th, tl, _, n_uni, _ = ref["count"][0]["out"]
    for cap in plan["query_caps"]:
        fn = make_sharded_build(mesh, "shard", k, LOCAL_CAP, cap)
        out, led = _jax_ledger_entry("dist_build",
                                     lambda: fn(th, tl, n_uni))
        ref["build"].append(dict(out=[np.asarray(x) for x in out],
                                 ledger=led))
    return ref


def _selfloop_cases():
    """Homopolymer runs >= k + 1 make self-loop nodes (succ[v] = v): a
    lone one, and one embedded between two random genomes (the reads of
    tests/test_dist.py::test_sharded_self_loop_cycle_parity). Both at
    k = 15, the case's, so that JAX's passes at S = 2 are built once."""
    g = random_genome(3000, seed=13) + "A" * 40 + random_genome(3000,
                                                                seed=14)
    island = simulate_reads(g, read_len=100, coverage=25, error_rate=0.0,
                            seed=15)
    return {"poly": (["N" * 30 + "A" * 30], JaxParams(k=15, min_coverage=1)),
            "island": (island, JaxParams(k=15, min_coverage=2))}


def _cases():
    _, reads, params = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    _, order, order_params = _case(1, 500, 60, 15, 0.01, False, 11, 2)
    shuffled = list(order)
    np.random.default_rng(5).shuffle(shuffled)
    _, retry, retry_params = _case(0, 300, 50, 10, 0.00, False, 11, 1)
    degen = JaxParams(k=15, min_coverage=1)
    replicated = ("case_replicated", reads, params,
                  {"sharded_simplify": False})
    jobs = {  # shard count -> (name, reads, JAX params, kwargs)
        1: [("case", reads, params, {}), replicated],
        2: [("case", reads, params, {}), replicated,
            ("retry", retry, retry_params, {"local_capacity": 64}),
            ("empty", [], degen, {}),
            ("short", ["ACGTACGT", "TTTT"], degen, {}),
            ("nheavy", ["N" * 60, "ACGTN" * 12, "N" * 30 + "A" * 30], degen,
             {}),
            ("bad_num_shards", reads, params, {"num_shards": 4}),
            # forced paths of the sharded simplify
            ("kill_md", reads, params, {"overrides": {"_KILL_MD": 2}}),
            ("bub_rung1", reads, params, {"overrides": {
                "_bub_mc": torch_dist_ranks.tiny_bub_mc_first_rung}}),
            ("bub_all", reads, params, {"overrides": {
                "_bub_mc": torch_dist_ranks.tiny_bub_mc}})]
            + [(name, r, p, {}) for name, (r, p) in _selfloop_cases().items()],
        4: [("case", reads, params, {}), replicated,
            ("order", order, order_params, {}),
            ("shuffled", shuffled, order_params, {})],
    }
    return reads, params, jobs


def _jax_graph(S, reads, params):
    """JAX's sharded count and build at roomy caps: (succ, okv_hi, okv_lo,
    counts, n_unique), global arrays."""
    ghi, glo, m = _jax_padded_stream(reads, params.k, S)
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    th, tl, cnts, n_uni, ovf = make_sharded_count(mesh, "shard", m + 64,
                                                  LOCAL_CAP)(
        ghi.reshape(-1), glo.reshape(-1),
        jnp.asarray([params.min_coverage], jnp.uint32))
    succ, okv_hi, okv_lo, bovf = make_sharded_build(
        mesh, "shard", params.k, LOCAL_CAP, 8 * LOCAL_CAP)(th, tl, n_uni)
    assert not np.asarray(ovf).any() and not np.asarray(bovf).any()
    return tuple(np.asarray(x) for x in (succ, okv_hi, okv_lo, cnts, n_uni))


def _rank_graphs(g, S):
    """A JAX graph as the ranks take it: (succ, okv, counts, n_unique)
    a rank, converted with genome_tpu_torch.convert."""
    succ, okv_hi, okv_lo, cnts, n_uni = g
    parts = zip(convert.shard_rows(succ, S, "cpu"),
                convert.shard_keys_from_pair(okv_hi, okv_lo, S, "cpu"),
                convert.shard_rows(cnts.astype(np.int32), S, "cpu"))
    return [(su.numpy(), okv.numpy(), c.numpy(), int(n))
            for (su, okv, c), n in zip(parts, n_uni)]


def _valid(n_uni):
    return (np.arange(LOCAL_CAP)[None, :] < np.asarray(n_uni)[:, None]
            ).reshape(-1)


def _jax_simplify(S, g, params):
    """JAX simplify_sharded on a graph: the alive mask, and the ledger's
    entries with each program's epochs (cost, invocations)."""
    succ, okv_hi, okv_lo, cnts, n_uni = g
    mesh = Mesh(np.array(jax.devices()[:S]), ("shard",))
    # sharded like the passes' outputs, so that no pass traces twice
    alive0 = jax.device_put(np.ones(S * LOCAL_CAP, bool),
                            NamedSharding(mesh, PartitionSpec("shard")))
    LEDGER.reset_invocations()
    alive, ovf = jax_dsimplify.simplify_sharded(
        mesh, "shard", LOCAL_CAP, succ, okv_hi, okv_lo, cnts, alive0, n_uni,
        params)
    assert not ovf
    summary = LEDGER.summary()
    cross = (S - 1) / S
    epochs = {name: [c.as_dict(cross) for c, _ in LEDGER.archived.get(name,
                                                                      [])]
              + [LEDGER.programs[name].as_dict(cross)]
              for name in SIMPLIFY_PROGRAMS}
    calls = {name: sum(n for _, n in LEDGER.archived.get(name, []))
             + summary[name]["invocations"] for name in SIMPLIFY_PROGRAMS}
    return dict(alive=np.asarray(alive), ledger=summary, epochs=epochs,
                calls=calls)


@pytest.fixture(scope="module")
def runs():
    """Per shard count: the plan, the JAX reference, the port's per-rank
    results, the jobs, JAX simplify_sharded on the graphs the ranks
    simplify, and JAX assemble_sharded's contigs, ledger and events."""
    reads, params, jobs = _cases()
    plans = {S: _plan(S, reads, params) for S in SHARDS}
    t0 = time.perf_counter()
    refs, graphs, port = {}, {}, {}
    # JAX builds each passes' programs anew per call: reuse them across
    # the calls at one shard count, capacity and thresholds
    with ThreadPoolExecutor(1) as pool, pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dsimplify, "make_sharded_simplify", functools.cache(
            jax_dsimplify.make_sharded_simplify))
        for S in SHARDS:  # the ranks of S run beside the JAX work after it
            refs[S] = _reference(S, plans[S], params)
            th, tl, cnts, n_uni, _ = refs[S]["count"][0]["out"]
            succ, okv_hi, okv_lo, _ = refs[S]["build"][0]["out"]
            graphs[S] = {"case": ((succ, okv_hi, okv_lo, cnts, n_uni),
                                  params)}
            if S == 2:
                graphs[S].update({name: (_jax_graph(S, r, p), p) for name,
                                  (r, p) in _selfloop_cases().items()})
            port[S] = pool.submit(
                run_local, torch_dist_ranks.parity, S, device="cpu",
                timeout_s=300,
                args=(reads, params.k, params.min_coverage,
                      plans[S]["pad_to"], plans[S]["bucket_caps"],
                      LOCAL_CAP, plans[S]["query_caps"],
                      [(n, r, _port_params(p), kw)
                       for n, r, p, kw in jobs[S]],
                      {"graphs": {name: (_rank_graphs(g, S),
                                         _port_params(p))
                                  for name, (g, p) in graphs[S].items()},
                       "ops_seed": OPS_SEED if S > 1 else None}))
        jax_simplify = {(S, name): _jax_simplify(S, g, p)
                        for S in (2, 4) for name, (g, p) in graphs[S].items()}
        jax_asm = {}
        for S in (2, 4):
            LEDGER.reset_invocations()
            m = JaxMetrics(quiet=True)
            contigs = jax_assemble_sharded(reads, params, num_shards=S,
                                           sharded_simplify=False, metrics=m)
            jax_asm[S] = (contigs, LEDGER.summary(), m.events)
        port = {S: f.result() for S, f in port.items()}
    print(f"ranks and JAX assembly: {time.perf_counter() - t0:.1f} s")
    return dict(reads=reads, params=params, refs=refs, port=port,
                jax_asm=jax_asm, graphs=graphs, jax_simplify=jax_simplify)


# ---- owner hash (in process) ----

@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_owner_of_matches_jax(S):
    rng = np.random.default_rng(S)
    rand = rng.integers(0, 1 << 62, size=5000, dtype=np.int64)
    reads, params = _case(2, 400, 50, 20, 0.02, False, 21, 2)[1:]
    jh, jl = jax_extract(jnp.asarray(pack_reads(reads)), 21)
    win = convert.keys_from_pair(np.asarray(jh), np.asarray(jl), "cpu")
    win = win[win != keys.SENTINEL]
    for v in (torch.from_numpy(rand), win):
        want = jax_owner_of_np(v.numpy().astype(np.uint64), S)
        assert torch.equal(owner_of(v, S), torch.from_numpy(want))
        assert np.array_equal(owner_of_np(v.numpy(), S), want)
    with pytest.raises(ValueError):
        owner_of(win, 3)


# ---- count ----

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_count_matches_jax(runs, S):
    ranks = runs["port"][S]
    th, tl, cnts, n_uni, ovf = runs["refs"][S]["count"][0]["out"]
    want_tab = convert.shard_keys_from_pair(th, tl, S, "cpu")
    want_cnt = convert.shard_rows(cnts.astype(np.int32), S, "cpu")
    got_keys = []
    for r, res in enumerate(ranks):
        got = res["count"][0]
        assert not got["overflow"] and not ovf.any()
        assert got["n_unique"] == int(n_uni[r])
        assert np.array_equal(got["table"], want_tab[r].numpy())
        assert np.array_equal(got["counts"], want_cnt[r].numpy())
        valid = got["table"][: got["n_unique"]]
        assert (owner_of_np(valid, S) == r).all()
        got_keys.append(np.stack([valid, got["counts"][: got["n_unique"]]],
                                 1))
    got = np.concatenate(got_keys)
    got = got[np.argsort(got[:, 0])]
    want_k, want_c = count_canonical_kmers(runs["reads"], runs["params"].k,
                                           runs["params"].min_coverage)
    assert np.array_equal(got[:, 0], want_k.astype(np.int64))
    assert np.array_equal(got[:, 1], want_c.astype(np.int64))


@pytest.mark.parametrize("S", SHARDS)
def test_count_overflow_matches_jax(runs, S):
    """At the fullest bucket's size no overflow, one below it overflow:
    the exact `per > bucket_cap` rule, on every rank alike."""
    ref = runs["refs"][S]["count"]
    for i, want in ((1, False), (2, True)):
        assert bool(ref[i]["out"][4].any()) is want
        assert [r["count"][i]["overflow"] for r in runs["port"][S]] == \
            [want] * S


# ---- build ----

@pytest.mark.parametrize("S", SHARDS)
def test_sharded_build_matches_jax(runs, S):
    succ, okv_hi, okv_lo, ovf = runs["refs"][S]["build"][0]["out"]
    want_succ = convert.shard_rows(succ, S, "cpu")
    want_okv = convert.shard_keys_from_pair(okv_hi, okv_lo, S, "cpu")
    assert not ovf.any()
    for r, res in enumerate(runs["port"][S]):
        got = res["build"][0]
        assert not got["overflow"]
        assert got["succ"].dtype == np.int32
        assert np.array_equal(got["succ"], want_succ[r].numpy())
        assert np.array_equal(got["okv"], want_okv[r].numpy())
    # global ids: at S > 1 some successor lives on another rank
    if S > 1:
        g = np.concatenate([r["build"][0]["succ"] for r in runs["port"][S]])
        src = np.repeat(np.arange(g.shape[0]) // (2 * LOCAL_CAP), 4)
        dst = g.reshape(-1) // (2 * LOCAL_CAP)
        assert ((g.reshape(-1) >= 0) & (dst != src)).any()


@pytest.mark.parametrize("S", SHARDS)
def test_build_overflow_matches_jax(runs, S):
    ref = runs["refs"][S]["build"]
    for i, want in ((1, False), (2, True)):
        assert bool(ref[i]["out"][3].any()) is want
        assert [r["build"][i]["overflow"] for r in runs["port"][S]] == \
            [want] * S
    # a build that did not overflow is the same at the fullest bucket's size
    for r, res in enumerate(runs["port"][S]):
        assert np.array_equal(res["build"][1]["succ"],
                              res["build"][0]["succ"])


@pytest.mark.parametrize("S", SHARDS)
def test_ledger_matches_jax(runs, S):
    """The count and build entries equal JAX's at every cap: a2a launches,
    bytes per rank and crossing, invocations."""
    ref = runs["refs"][S]
    for prog in ("count", "build"):
        for i, want in enumerate(ref[prog]):
            for res in runs["port"][S]:
                assert res[prog][i]["ledger"] == want["ledger"]


# ---- assemble_sharded ----

def _assembled(runs, S, name):
    """Every rank's contigs (all equal) and rank 0's metrics events."""
    got = [r["assemble"][name] for r in runs["port"][S]]
    assert all(g["contigs"] == got[0]["contigs"] for g in got)
    return got[0]["contigs"], got[0]["events"]


def _phase_ends(events):
    return {e["phase"]: e for e in events if e["event"] == "phase_end"}


@pytest.mark.parametrize("S", SHARDS)
def test_assemble_sharded_matches_jax_and_golden(runs, S):
    """The default (sharded simplify) and sharded_simplify=False give the
    golden contigs through their own phases."""
    want = assemble_golden(runs["reads"], runs["params"])
    for name, phases in (("case", SHARDED_PHASES),
                         ("case_replicated", PHASES)):
        contigs, events = _assembled(runs, S, name)
        assert contigs == want and want
        if S in runs["jax_asm"]:
            assert contigs == runs["jax_asm"][S][0]
        ends = _phase_ends(events)
        assert tuple(ends) == phases
        # every rank holds fewer nodes than local_cap: the gathered graph
        # has a hole at the tail of every shard
        assert (ends["dist_count"]["n_unique_total"]
                < ends["dist_count"]["local_cap"])
    events = _assembled(runs, S, "case")[1]
    assert _phase_ends(events)["dist_simplify_sharded"]["overflow"] is False
    assert not any(e["event"] == "dist_simplify_overflow_fallback"
                   for e in events)


@pytest.mark.parametrize("S", [2, 4])
def test_assemble_ledger_matches_jax(runs, S):
    """The build's caps follow from the shrunk table, the same in both, so
    its entry is JAX's. The count's bucket_cap follows from the padded
    stream length, and JAX's extraction pads windows (read length to a
    multiple of 8, batches to 256 reads) where the port does not: its
    bytes are the port's own bucket_cap's, the rest equals JAX's. Both
    take the replicated simplify here."""
    _, events = _assembled(runs, S, "case_replicated")
    got = next(e for e in events if e["event"] == "exchange_ledger")
    want = runs["jax_asm"][S][1]
    assert got["dist_build"] == want["dist_build"]
    windows = next(e for e in events if e["event"] == "phase_end"
                   and e["phase"] == "dist_extract")["windows"]
    bucket_cap = max(64, int(1.3 * (windows // S) / S) + 64)
    assert got["dist_count"]["mb_per_shard"] == round(
        S * bucket_cap * 8 / 1e6, 3)
    for key in ("a2a", "psum", "dyn_a2a_cap", "invocations"):
        assert got["dist_count"][key] == want["dist_count"][key]
    assert got["_totals"]["a2a_invoked"] == want["_totals"]["a2a_invoked"]
    assert got["_totals"]["num_shards"] == S


def test_assemble_read_order_invariance(runs):
    _, reads, params = _case(1, 500, 60, 15, 0.01, False, 11, 2)
    a, _ = _assembled(runs, 4, "order")
    b, _ = _assembled(runs, 4, "shuffled")
    assert a == b == assemble_golden(reads, params)


def test_assemble_capacity_retry(runs):
    _, reads, params = _case(0, 300, 50, 10, 0.00, False, 11, 1)
    contigs, events = _assembled(runs, 2, "retry")
    assert contigs == assemble_golden(reads, params)
    retries = [e for e in events if e["event"] == "dist_capacity_overflow"]
    assert [e["local_cap"] for e in retries] == [128, 256]
    ledger = next(e for e in events if e["event"] == "exchange_ledger")
    assert ledger["dist_count"]["retry_epochs"] == len(retries)


def test_assemble_degenerate_inputs(runs):
    params = JaxParams(k=15, min_coverage=1)
    for name, reads in [("empty", []), ("short", ["ACGTACGT", "TTTT"]),
                        ("nheavy", ["N" * 60, "ACGTN" * 12,
                                    "N" * 30 + "A" * 30])]:
        contigs, _ = _assembled(runs, 2, name)
        assert contigs == assemble_golden(reads, params), name
    assert _assembled(runs, 2, "nheavy")[0] == ["A" * 15]


def test_assemble_num_shards_must_match_group(runs):
    contigs, _ = _assembled(runs, 2, "bad_num_shards")
    assert contigs.startswith("ValueError: num_shards=4")


def test_shard_reads_list_and_code_matrix():
    reads = [f"ACGT{i}" for i in range(7)]
    assert shard_reads(reads, 4) == jax_shard_reads(reads, 4)
    codes = np.arange(7 * 3, dtype=np.uint8).reshape(7, 3)
    parts = shard_reads(codes, 4)
    assert [p.shape[0] for p in parts] == [2, 2, 2, 1]
    assert np.array_equal(np.concatenate(parts), codes)


# ---- the sharded simplify ----

def _port_alive(runs, S, name):
    """The port's sharded alive mask of a graph (every rank's, in rank
    order); no rank overflowed."""
    res = [r["simplify"][name] for r in runs["port"][S]]
    assert not any(x["overflow"] for x in res)
    return np.concatenate([x["alive"] for x in res])


def _port_replicated_alive(g, params):
    """The port's replicated passes on the gathered JAX graph."""
    succ, okv_hi, okv_lo, cnts, n_uni = g
    succ_t, okv = convert.graph_from_jax(succ, okv_hi, okv_lo, "cpu")
    valid = torch.from_numpy(_valid(n_uni))
    return simplify_with_metrics(
        succ_t, okv, torch.from_numpy(cnts.astype(np.int32)),
        torch.ones_like(valid), valid, _port_params(params)).numpy()


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_simplify_matches_jax_and_replicated(runs, S):
    """On the JAX graph of each shard count: alive & valid equals JAX
    simplify_sharded's (S = 2, 4) and the port's replicated passes'."""
    g, params = runs["graphs"][S]["case"]
    valid = _valid(g[4])
    got = _port_alive(runs, S, "case") & valid
    assert (got == _port_replicated_alive(g, params) & valid).all()
    assert got.sum() < valid.sum()  # the passes killed something
    if S > 1:
        assert (got == runs["jax_simplify"][S, "case"]["alive"] & valid).all()


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_simplify_ledger_matches_jax(runs, S):
    """dist_degrees, dist_tips and dist_bubbles equal JAX's entries key for
    key. JAX traces the tips pass twice at the same caps (its first call
    takes the unsharded initial alive mask, the later ones a sharded
    one), so its summary shows that pass's first call as a retry epoch of
    equal cost; the port counts every call at one key as an invocation,
    so its invocations are JAX's calls over both epochs, and it has no
    retry_epochs."""
    ref = runs["jax_simplify"][S, "case"]
    for res in runs["port"][S]:
        got = res["simplify"]["case"]["ledger"]
        for name in SIMPLIFY_PROGRAMS:
            want = dict(ref["ledger"][name])
            assert all(e == ref["epochs"][name][-1]
                       for e in ref["epochs"][name])
            want.pop("retry_epochs", None)
            want["invocations"] = ref["calls"][name]
            assert got[name] == want, name
            assert got[name]["psum"] == 0 and got[name]["dyn_a2a_cap"] == 0
        assert got["_totals"] == ref["ledger"]["_totals"]
    assert ref["calls"]["dist_tips"] > 1  # a pass called again, same caps


@pytest.mark.parametrize("name", ["poly", "island"])
def test_sharded_simplify_self_loop_matches_jax(runs, name):
    """Self-loop nodes at S = 2: alive & valid equals JAX's and the port's
    replicated passes', and assemble_sharded gives the golden contigs."""
    g, params = runs["graphs"][2][name]
    valid = _valid(g[4])
    got = _port_alive(runs, 2, name) & valid
    assert (got == runs["jax_simplify"][2, name]["alive"] & valid).all()
    assert (got == _port_replicated_alive(g, params) & valid).all()
    contigs, events = _assembled(runs, 2, name)
    reads = _selfloop_cases()[name][0]
    assert contigs == assemble_golden(reads, params)
    assert tuple(_phase_ends(events)) == SHARDED_PHASES
    if name == "poly":
        assert contigs == ["A" * 15]


def _ledger(events):
    return next(e for e in events if e["event"] == "exchange_ledger")


def test_sharded_simplify_fresh_degrees_every_round(runs):
    """_KILL_MD = 2: the incremental update overflows on every pass that
    kills more than 2 canonicals a rank, so degrees are recomputed after
    it; the contigs stay golden."""
    contigs, events = _assembled(runs, 2, "kill_md")
    assert contigs == assemble_golden(runs["reads"], runs["params"])
    got = _ledger(events)
    base = _ledger(_assembled(runs, 2, "case")[1])
    assert base["dist_degrees"]["invocations"] == 1
    assert got["dist_degrees"]["invocations"] >= got["dist_tips"][
        "invocations"]
    assert "retry_epochs" not in got["dist_degrees"]
    assert _phase_ends(events)["dist_simplify_sharded"]["overflow"] is False


def test_sharded_simplify_slack_retry(runs):
    """_bub_mc = 2 on the first rung: the bubble candidates overflow it,
    the ladder retries once with doubled slack, and the contigs stay
    golden without the fallback."""
    contigs, events = _assembled(runs, 2, "bub_rung1")
    assert contigs == assemble_golden(runs["reads"], runs["params"])
    got = _ledger(events)
    for name in SIMPLIFY_PROGRAMS:
        assert got[name]["retry_epochs"] == 1, name
    assert _phase_ends(events)["dist_simplify_sharded"]["overflow"] is False
    assert not any(e["event"] == "dist_simplify_overflow_fallback"
                   for e in events)


def test_sharded_simplify_ladder_exhausted_falls_back(runs):
    """_bub_mc = 2 on every rung: the ladder is used up, the event is
    logged, and the replicated passes give the golden contigs."""
    contigs, events = _assembled(runs, 2, "bub_all")
    assert contigs == assemble_golden(runs["reads"], runs["params"])
    assert _phase_ends(events)["dist_simplify_sharded"]["overflow"] is True
    assert sum(e["event"] == "dist_simplify_overflow_fallback"
               for e in events) == 1
    assert any(e["event"] == "simplify_round" for e in events)
    assert _ledger(events)["dist_degrees"]["retry_epochs"] == 2


@pytest.mark.parametrize("S", [2, 4])
def test_dist_simplify_alive_counts_valid_nodes(runs, S):
    """The dist_simplify phase's `alive` counts alive & valid, on purpose:
    JAX's counts every slot of the gathered graph, the holes at each
    shard's tail included, so it is larger by exactly the holes. The
    default sharded path has no dist_simplify phase: its final state
    and emission stay sharded."""
    g = runs["graphs"][S]["case"][0]
    valid = _valid(g[4])
    want = int((runs["jax_simplify"][S, "case"]["alive"] & valid).sum())
    jax_alive = _phase_ends(runs["jax_asm"][S][2])["dist_simplify"]["alive"]
    assert jax_alive == want + int((~valid).sum())
    got = _phase_ends(_assembled(runs, S, "case_replicated")[1])
    assert got["dist_simplify"]["alive"] == want < jax_alive
    assert "dist_simplify" not in _phase_ends(_assembled(runs, S, "case")[1])


def _ops_cases(S):
    return [torch_dist_ranks.ops_case(OPS_SEED, S, r) for r in range(S)]


@pytest.mark.parametrize("S", [2, 4])
def test_remote_gather_matches_plain_gather(runs, S):
    """remote_gather equals a plain gather of the global arrays where
    valid, the defaults elsewhere (duplicate, invalid and owner-local
    requests); at cap 1 it overflows exactly where a rank asks some other
    rank for more than one distinct id."""
    w = torch_dist_ranks.OPS_WIDTH
    for c, res in zip(_ops_cases(S), runs["port"][S]):
        got = res["ops"]
        idx = np.clip(c["idx"], 0, None)
        assert np.array_equal(got["o32"],
                              np.where(c["valid"], c["v32"][idx], -7))
        assert np.array_equal(got["o64"],
                              np.where(c["valid"], c["v64"][idx], c["d64"]))
        assert not got["ovf"]
    want1 = []
    for r, c in enumerate(_ops_cases(S)):
        ids = np.unique(c["idx"][c["valid"]])
        per = np.bincount(ids // w, minlength=S)
        per[r] = 0
        want1.append(bool((per > 1).any()))
    assert [res["ops"]["ovf1"] for res in runs["port"][S]] == want1
    assert any(want1)


@pytest.mark.parametrize("S", [2, 4])
def test_seg_route_matches_segment_reduction(runs, S):
    """seg_route delivers each valid record's (max, sum, min) to its
    segment's owner, at most one record a (sender, segment): reduced
    again at the owner they equal the global segment reduction."""
    w = torch_dist_ranks.OPS_WIDTH
    cases = _ops_cases(S)
    seg = np.concatenate([c["idx"][c["valid"]] for c in cases])
    vals = np.concatenate([c["vals"][:, c["valid"]] for c in cases], 1)
    for r, res in enumerate(runs["port"][S]):
        got = res["ops"]
        assert not got["seg_ovf"]
        lseg, present = got["lseg"], got["present"]
        cap = lseg.shape[0] // S
        for sender in range(S):  # one record a (sender, segment)
            rows = lseg[sender * cap : (sender + 1) * cap]
            rows = rows[present[sender * cap : (sender + 1) * cap]]
            assert np.unique(rows).size == rows.size
        assert (lseg[~present] == w).all()
        for j in range(w):
            at = present & (lseg == j)
            mine = seg == r * w + j
            assert at.any() == mine.any()
            if mine.any():
                rv = [x[at] for x in got["routed"]]
                assert rv[0].max() == vals[0, mine].max()
                assert rv[1].sum() == vals[1, mine].sum()
                assert rv[2].min() == vals[2, mine].min()


def test_ledger_counts_a_call_at_the_same_key_as_an_invocation():
    """A call at its program's last key records nothing new and counts
    one invocation more; a call at a new key archives a retry epoch."""
    led = ExchangeLedger()
    for key, nbytes in ((1, 800_000), (1, 800_000), (1, 800_000),
                        (2, 1_600_000)):
        led.program("p", key)
        led.record_a2a(2, nbytes)
        led.invoke("p")
    got = led.summary()
    assert got["p"]["invocations"] == 1 and got["p"]["retry_epochs"] == 1
    assert got["p"]["a2a"] == 1 and got["p"]["mb_per_shard"] == 1.6
    assert got["_totals"]["a2a_invoked"] == 4
    assert got["_totals"]["mb_crossing_invoked"] == 2.0  # 3 x 0.4 + 0.8


# ---- refusals: no fallback hides the device, backend or path ----

def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        assemble_sharded(["ACGT" * 10], AssemblyParams(k=11))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_group(0, 1, "file:///nonexistent", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_local(torch_dist_ranks.sleep, 1, args=(0,))  # cuda by default


def test_nccl_with_cpu_device_raises(tmp_path):
    with pytest.raises(ValueError, match="does not serve device cpu"):
        init_group(0, 1, f"file://{tmp_path}/rdzv", device="cpu",
                   backend="nccl")


def test_run_local_raises_when_a_rank_fails():
    t0 = time.perf_counter()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        run_local(torch_dist_ranks.fail_on_rank_1, 2, device="cpu",
                  timeout_s=60)
    assert time.perf_counter() - t0 < 50


def test_run_local_deadline_kills_ranks():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="still running after 5"):
        run_local(torch_dist_ranks.sleep, 1, device="cpu", timeout_s=5,
                  args=(120,))
    assert time.perf_counter() - t0 < 30
