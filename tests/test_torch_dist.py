"""The port's hash-sharded path (genome_tpu_torch/dist) against the JAX
package's, exactly, on gloo groups of 1, 2 and 4 ranks started by
run_local: the owner hash, each rank's count table and overflow flag,
the build's succ (global ids) and okv and its overflow flag, the exchange
ledger's count and build entries, and assemble_sharded's contigs against
JAX assemble_sharded and the golden oracle. Every comparison is exact.

One run_local a shard count (module fixture) computes what every test
reads; the JAX references run in this process meanwhile."""

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from genome_tpu.assemble.pipeline import extract_stream as jax_extract_stream
from genome_tpu.dist import assemble_sharded as jax_assemble_sharded
from genome_tpu.dist.assemble import shard_reads as jax_shard_reads
from genome_tpu.dist.build import make_sharded_build
from genome_tpu.dist.count import make_sharded_count
from genome_tpu.dist.ledger import LEDGER
from genome_tpu.dist.partition import owner_of_np as jax_owner_of_np
from genome_tpu.golden import assemble_golden
from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.kernels import u64
from genome_tpu.kernels.extract import SENTINEL as JAX_SENTINEL
from genome_tpu.kernels.extract import extract_canonical_kmers as jax_extract
from genome_tpu.params import AssemblyParams as JaxParams
from genome_tpu_torch import convert
from genome_tpu_torch.dist import (assemble_sharded, owner_of_np, run_local,
                                   shard_reads)
from genome_tpu_torch.dist.mesh import init_group, shard_device
from genome_tpu_torch.dist.partition import owner_of
from genome_tpu_torch.kernels import keys
from genome_tpu_torch.kernels.extract import pack_reads
from genome_tpu_torch.params import AssemblyParams

from tests import torch_dist_ranks
from tests.test_golden import _case

LOCAL_CAP = 8192
SHARDS = (1, 2, 4)
PHASES = ("dist_extract", "dist_count", "dist_build", "dist_simplify",
          "dist_contigs")


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


def _cases():
    _, reads, params = _case(4, 800, 70, 18, 0.015, True, 15, 2)
    _, order, order_params = _case(1, 500, 60, 15, 0.01, False, 11, 2)
    shuffled = list(order)
    np.random.default_rng(5).shuffle(shuffled)
    _, retry, retry_params = _case(0, 300, 50, 10, 0.00, False, 11, 1)
    degen = JaxParams(k=15, min_coverage=1)
    jobs = {  # shard count -> (name, reads, JAX params, kwargs)
        1: [("case", reads, params, {})],
        2: [("case", reads, params, {}),
            ("retry", retry, retry_params, {"local_capacity": 64}),
            ("empty", [], degen, {}),
            ("short", ["ACGTACGT", "TTTT"], degen, {}),
            ("nheavy", ["N" * 60, "ACGTN" * 12, "N" * 30 + "A" * 30], degen,
             {}),
            ("bad_num_shards", reads, params, {"num_shards": 4})],
        4: [("case", reads, params, {}),
            ("order", order, order_params, {}),
            ("shuffled", shuffled, order_params, {})],
    }
    return reads, params, jobs


@pytest.fixture(scope="module")
def runs():
    """Per shard count: the plan, the JAX reference, the port's per-rank
    results, the jobs, and JAX assemble_sharded's contigs and ledger."""
    reads, params, jobs = _cases()
    plans = {S: _plan(S, reads, params) for S in SHARDS}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # the ranks run beside JAX below
        port = {S: pool.submit(
                    run_local, torch_dist_ranks.parity, S, device="cpu",
                    timeout_s=300,
                    args=(reads, params.k, params.min_coverage,
                          plans[S]["pad_to"], plans[S]["bucket_caps"],
                          LOCAL_CAP, plans[S]["query_caps"],
                          [(n, r, _port_params(p), kw)
                           for n, r, p, kw in jobs[S]]))
                for S in SHARDS}
        refs = {S: _reference(S, plans[S], params) for S in SHARDS}
        jax_asm = {}
        for S in (2, 4):
            LEDGER.reset_invocations()
            contigs = jax_assemble_sharded(reads, params, num_shards=S,
                                           sharded_simplify=False)
            jax_asm[S] = (contigs, LEDGER.summary())
        port = {S: f.result() for S, f in port.items()}
    print(f"ranks and JAX assembly: {time.perf_counter() - t0:.1f} s")
    return dict(reads=reads, params=params, refs=refs, port=port,
                jax_asm=jax_asm)


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


@pytest.mark.parametrize("S", SHARDS)
def test_assemble_sharded_matches_jax_and_golden(runs, S):
    contigs, events = _assembled(runs, S, "case")
    want = assemble_golden(runs["reads"], runs["params"])
    assert contigs == want and want
    if S in runs["jax_asm"]:
        assert contigs == runs["jax_asm"][S][0]
    ends = {e["phase"]: e for e in events if e["event"] == "phase_end"}
    assert tuple(ends) == PHASES
    # every rank holds fewer nodes than local_cap: the gathered graph has
    # a hole at the tail of every shard
    assert ends["dist_count"]["n_unique_total"] < ends["dist_count"]["local_cap"]


@pytest.mark.parametrize("S", [2, 4])
def test_assemble_ledger_matches_jax(runs, S):
    """The build's caps follow from the shrunk table, the same in both, so
    its entry is JAX's. The count's bucket_cap follows from the padded
    stream length, and JAX's extraction pads windows (read length to a
    multiple of 8, batches to 256 reads) where the port does not: its
    bytes are the port's own bucket_cap's, the rest equals JAX's."""
    _, events = _assembled(runs, S, "case")
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


# ---- refusals: no fallback hides the device, backend or path ----

def test_sharded_simplify_true_raises():
    with pytest.raises(NotImplementedError, match="dist/simplify.py"):
        assemble_sharded(["ACGT" * 10], AssemblyParams(k=11),
                         sharded_simplify=True, device="cpu")


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
