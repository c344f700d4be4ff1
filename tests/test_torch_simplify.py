"""Graph simplification and final chain state in the port against the JAX
package, exactly: the alive mask (and carried degrees and links) after
every tips and bubbles pass, every rung of the walk-buffer ladder and the
dense fallback (run_pass_inc and the public clip_tips_pass /
pop_bubbles_pass), the simplify_device fixpoint loop, the ruler ranking's
(head, dist, ok), and (head, dist, primary) of final_chain_state,
including a circular genome that takes the cycle fallback."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from genome_tpu.golden.assembler import count_canonical_kmers
from genome_tpu.graph import simplify as jsimp
from genome_tpu.graph.build import build_graph_device as jax_build
from genome_tpu.kernels import u64
from genome_tpu.params import AssemblyParams
from genome_tpu_torch import convert
from genome_tpu_torch.graph import simplify as simp
from genome_tpu_torch.io import random_genome, simulate_reads

from tests.torch_cpu import one_torch_thread  # noqa: F401


def _np(x):
    return np.asarray(x.numpy() if torch.is_tensor(x) else x)


def _graph(reads, k=13, min_cov=2):
    """The same graph on both sides: JAX build, carried to the port."""
    kmers, counts = count_canonical_kmers(reads, k, min_cov)
    cap = kmers.size + (-kmers.size) % 8
    th = np.zeros(cap, np.uint32)
    tl = np.zeros(cap, np.uint32)
    th[: kmers.size], tl[: kmers.size] = u64.from_u64_np(kmers)
    cnt = np.zeros(cap, np.uint32)
    cnt[: kmers.size] = counts
    succ, okh, okl = jax_build(jnp.asarray(th), jnp.asarray(tl),
                               jnp.int32(kmers.size), k)
    valid = np.arange(cap) < kmers.size
    jax_g = dict(succ=succ, okh=okh, okl=okl, cnt=jnp.asarray(cnt),
                 valid=jnp.asarray(valid))
    psucc, okv = convert.graph_from_jax(np.asarray(succ), np.asarray(okh),
                                        np.asarray(okl), device="cpu")
    port_g = dict(succ=psucc, okv=okv,
                  cnt=torch.from_numpy(cnt.astype(np.int32)),
                  valid=torch.from_numpy(valid))
    return jax_g, port_g, AssemblyParams(k=k, min_coverage=min_cov), cap


def _error_graph(seed=17, glen=1500, err=0.02):
    """Error-heavy fixture: plenty of tips AND bubbles, many chain heads."""
    return _graph(simulate_reads(random_genome(glen, seed=seed), read_len=80,
                                 coverage=25, error_rate=err, seed=seed + 1))


def _jax_pass(kind, j, alive, params, deg, links, walk_m=jsimp._WALK_M):
    thr = params.tip_len_eff if kind == "tips" else params.bubble_len_eff
    return jsimp.run_pass_inc(kind, j["succ"], j["okh"], j["okl"], j["cnt"],
                              alive, j["valid"], jnp.int32(thr), thr, deg,
                              links, walk_m=walk_m)


def _port_pass(kind, p, alive, params, deg, links, walk_m=simp._WALK_M):
    thr = params.tip_len_eff if kind == "tips" else params.bubble_len_eff
    return simp.run_pass_inc(kind, p["succ"], p["okv"], p["cnt"], alive,
                             p["valid"], thr, thr, deg, links, walk_m=walk_m)


def _assert_pair_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        for x, y in zip(a, b):
            assert np.array_equal(_np(x), _np(y)), what


def test_every_pass_matches_jax():
    """Lockstep fixpoint loop: alive, changed, carried degrees and links
    equal JAX's after every tips and bubbles pass."""
    j, p, params, cap = _error_graph(seed=29, glen=1800)
    ja = jnp.ones((cap,), jnp.bool_)
    pa = torch.ones(cap, dtype=torch.bool)
    jdeg = jl = pdeg = pl = None
    kills = 0
    for rnd in range(params.max_rounds):
        changed = False
        for kind in ("tips", "bubbles"):
            ja, jch, _, jdeg, jl = _jax_pass(kind, j, ja, params, jdeg, jl)
            pa, pch, _, pdeg, pl = _port_pass(kind, p, pa, params, pdeg, pl)
            assert np.array_equal(_np(pa), np.asarray(ja)), (rnd, kind)
            assert bool(pch) == bool(jch), (rnd, kind)
            _assert_pair_equal(pdeg, jdeg, (rnd, kind, "degrees"))
            _assert_pair_equal(pl, jl, (rnd, kind, "links"))
            changed |= bool(pch)
        kills = int((~pa & p["valid"]).sum())
        if not changed:
            break
    assert kills > 0 and rnd > 0, "fixture must exercise real kills"


@pytest.mark.parametrize("kind", ["tips", "bubbles"])
@pytest.mark.parametrize("rung", ["first_fits", "second_fits", "dense"])
def test_ladder_rungs_match_jax(kind, rung):
    """Force each walk_m rung and the dense fallback, as
    tests/test_walk_ladder.py does for the JAX package."""
    j, p, params, cap = _error_graph()
    ja = jnp.ones((cap,), jnp.bool_)
    pa = torch.ones(cap, dtype=torch.bool)
    if kind == "bubbles":  # bubbles on the post-tip graph
        ja = _jax_pass("tips", j, ja, params, None, None)[0]
        pa = _port_pass("tips", p, pa, params, None, None)[0]
    outdeg, usucc = simp._degrees(p["succ"], simp._alive_o(pa, p["valid"]))
    _, prev_u = simp._links(outdeg, usucc)
    nh = int((simp._alive_o(pa, p["valid"]) & (prev_u < 0)).sum())
    assert nh > 8, "fixture must have many chain heads"
    small = 1 << max(1, (nh // 4).bit_length() - 1)
    big = 1 << nh.bit_length()
    ladder = {"first_fits": (big,), "second_fits": (small, big),
              "dense": (small, small)}[rung]
    ja2, jch, *_ = _jax_pass(kind, j, ja, params, None, None, walk_m=ladder)
    pa2, pch, _, pdeg, _ = _port_pass(kind, p, pa, params, None, None,
                                      walk_m=ladder)
    assert np.array_equal(_np(pa2), np.asarray(ja2))
    assert bool(pch) == bool(jch) and bool(pch)
    assert (pdeg is None) == (rung == "dense")


@pytest.mark.parametrize("kind", ["tips", "bubbles"])
@pytest.mark.parametrize("truncated", [False, True])
def test_dense_passes_match_jax(kind, truncated):
    j, p, params, cap = _error_graph(seed=31, glen=1200)
    thr = params.tip_len_eff if kind == "tips" else params.bubble_len_eff
    max_len = thr if truncated else None
    jfn = (jsimp.clip_tips_pass_dense if kind == "tips"
           else jsimp.pop_bubbles_pass_dense)
    pfn = (simp.clip_tips_pass_dense if kind == "tips"
           else simp.pop_bubbles_pass_dense)
    ja, jch = jfn(j["succ"], j["okh"], j["okl"], j["cnt"],
                  jnp.ones((cap,), jnp.bool_), j["valid"], jnp.int32(thr),
                  max_len=max_len)
    pa, pch = pfn(p["succ"], p["okv"], p["cnt"], torch.ones(cap, dtype=bool),
                  p["valid"], thr, max_len=max_len)
    assert np.array_equal(_np(pa), np.asarray(ja)) and bool(pch) == bool(jch)


def _assert_final_equal(j, p, jalive):
    jfs = jsimp.final_chain_state(j["succ"], j["okh"], j["okl"], j["cnt"],
                                  jalive, j["valid"])
    pfs = simp.final_chain_state(p["succ"], p["okv"], p["cnt"],
                                 torch.from_numpy(np.array(jalive)),
                                 p["valid"])
    for key in ("head", "dist", "primary", "alive_o"):
        assert np.array_equal(_np(pfs[key]), np.asarray(jfs[key])), key
    return pfs


def test_final_chain_state_matches_jax_after_fixpoint():
    j, p, params, cap = _error_graph(seed=23, glen=1000)
    jalive = jsimp.simplify_device(j["succ"], j["okh"], j["okl"], j["cnt"],
                                   jnp.ones((cap,), jnp.bool_), j["valid"],
                                   params)
    pfs = _assert_final_equal(j, p, jalive)
    assert bool(simp._rank_rulers(simp._links(*simp._degrees(
        p["succ"], pfs["alive_o"]))[1])[2]), "acyclic: fast path"


def test_final_chain_state_circular_takes_cycle_fallback():
    reads = simulate_reads(random_genome(1500, seed=5), read_len=80,
                           coverage=20, circular=True, seed=8)
    j, p, params, cap = _graph(reads, k=15)
    alive = torch.ones(cap, dtype=torch.bool)
    _, prev_u = simp._links(*simp._degrees(p["succ"],
                                           simp._alive_o(alive, p["valid"])))
    assert not bool(simp._rank_rulers(prev_u)[2]), \
        "circular genome: a cycle"
    pfs = _assert_final_equal(j, p, jnp.ones((cap,), jnp.bool_))
    assert int(pfs["primary"].sum()) == 1


def _random_chains(rng, n_nodes, n_chains, with_cycle=False):
    n2 = 2 * n_nodes
    perm = rng.permutation(n_nodes) * 2
    cuts = np.sort(rng.choice(np.arange(1, n_nodes), n_chains - 1,
                              replace=False)) if n_chains > 1 else []
    prev_u = np.full(n2, -1, np.int32)
    for si, s in enumerate(np.split(perm, cuts)):
        prev_u[s[1:]] = s[:-1]
        if with_cycle and si == 0 and len(s) > 2:
            prev_u[s[0]] = s[-1]
    return prev_u


@pytest.mark.parametrize("seed,n,chains", [(0, 50, 1), (1, 1000, 40),
                                           (3, 64, 64)])
def test_rank_matches_sequential_walk(seed, n, chains):
    prev_u = _random_chains(np.random.default_rng(seed), n, chains)
    head, dist, ok, _ = simp._rank_rulers(torch.from_numpy(prev_u))
    assert bool(ok)
    for v in range(prev_u.size):
        h, d = v, 0
        while prev_u[h] >= 0:
            h, d = prev_u[h], d + 1
        assert int(head[v]) == h and int(dist[v]) == d


def test_rank_detects_cycle():
    prev_u = _random_chains(np.random.default_rng(5), 400, 3, with_cycle=True)
    assert not bool(simp._rank_rulers(torch.from_numpy(prev_u))[2])


def _next_of(prev_u):
    """The next links of a prev-link array (JAX's _rank_rulers takes
    both)."""
    nxt = np.full(prev_u.size, -1, np.int32)
    has = prev_u >= 0
    nxt[prev_u[has]] = np.nonzero(has)[0]
    return nxt


def _rank_case(name):
    rng = np.random.default_rng(11)
    if name == "chains":
        return _random_chains(rng, 2000, 60)
    if name == "cycle":
        return _random_chains(rng, 600, 4, with_cycle=True)
    if name == "long_gap":  # one chain of 1500 non-rulers: gap > 2^9
        prev_u = np.full(4096, -1, np.int32)
        ids = np.array([i for i in range(4096) if i % simp.RULER_STRIDE])
        ids = ids[rng.permutation(ids.size)[:1500]]
        prev_u[ids[1:]] = ids[:-1]
        return prev_u
    # n2 = 2011: the last ruler block is cut short
    prev_u = _random_chains(rng, 1005, 7)
    return np.concatenate([prev_u, np.full(1, -1, np.int32)])


@pytest.mark.parametrize("name", ["chains", "cycle", "long_gap",
                                  "ragged_n2"])
def test_rank_rulers_matches_jax(name):
    prev_u = _rank_case(name)
    jh, jd, jok = jsimp._rank_rulers(jnp.asarray(_next_of(prev_u)),
                                     jnp.asarray(prev_u))
    head, dist, ok, (r1, r2) = simp._rank_rulers(torch.from_numpy(prev_u))
    assert np.array_equal(head.numpy(), np.asarray(jh))
    assert np.array_equal(dist.numpy(), np.asarray(jd))
    assert bool(ok) == bool(jok) == (name != "cycle")
    assert r1 >= (10 if name == "long_gap" else 1) and r2 >= 1


@pytest.mark.parametrize("kind", ["tips", "bubbles"])
@pytest.mark.parametrize("rung", ["first_fits", "second_fits", "dense",
                                  "max_len_none"])
def test_public_passes_match_jax(kind, rung):
    """clip_tips_pass / pop_bubbles_pass at each walk_m rung, on the
    dense fallback and with max_len=None: alive, changed and the pre-kill
    links equal JAX's, and with_links=False returns the same pair."""
    j, p, params, cap = _error_graph(seed=37, glen=1300)
    thr = params.tip_len_eff if kind == "tips" else params.bubble_len_eff
    jfn = jsimp.clip_tips_pass if kind == "tips" else jsimp.pop_bubbles_pass
    pfn = simp.clip_tips_pass if kind == "tips" else simp.pop_bubbles_pass
    outdeg, usucc = simp._degrees(p["succ"], simp._alive_o(
        torch.ones(cap, dtype=torch.bool), p["valid"]))
    nh = int((simp._links(outdeg, usucc)[1] < 0).sum())
    small = 1 << max(1, (nh // 4).bit_length() - 1)
    big = 1 << nh.bit_length()
    ladder = {"first_fits": (big,), "second_fits": (small, big),
              "dense": (small, small), "max_len_none": (big,)}[rung]
    max_len = None if rung == "max_len_none" else thr
    ja, jch, jl = jfn(j["succ"], j["okh"], j["okl"], j["cnt"],
                      jnp.ones((cap,), jnp.bool_), j["valid"], jnp.int32(thr),
                      max_len=max_len, walk_m=ladder, with_links=True)
    args = (p["succ"], p["okv"], p["cnt"], torch.ones(cap, dtype=torch.bool),
            p["valid"], thr)
    pa, pch, pl = pfn(*args, max_len=max_len, walk_m=ladder, with_links=True)
    assert np.array_equal(_np(pa), np.asarray(ja))
    assert bool(pch) == bool(jch) and bool(pch)
    _assert_pair_equal(pl, jl, "links")
    assert (pl is None) == (rung in ("dense", "max_len_none"))
    pa2, pch2 = pfn(*args, max_len=max_len, walk_m=ladder)
    assert torch.equal(pa2, pa) and bool(pch2) == bool(pch)


@pytest.mark.parametrize("with_links", [False, True])
def test_simplify_device_matches_jax(with_links):
    """The fixpoint loop: the alive mask (and the final round's links)
    equal JAX's simplify_device; the pipeline's simplify_device alias
    gives the same, with a simplify_round event a round."""
    from genome_tpu_torch.assemble import pipeline
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.graph import simplify_device
    j, p, params, cap = _error_graph(seed=29, glen=1800)
    want = jsimp.simplify_device(j["succ"], j["okh"], j["okl"], j["cnt"],
                                 jnp.ones((cap,), jnp.bool_), j["valid"],
                                 params, with_links=with_links)
    args = (p["succ"], p["okv"], p["cnt"], torch.ones(cap, dtype=torch.bool),
            p["valid"], params)
    got = simplify_device(*args, with_links=with_links)
    if with_links:
        (got, links), (want, wlinks) = got, want
        assert links is not None
        _assert_pair_equal(links, wlinks, "links")
    assert np.array_equal(_np(got), np.asarray(want))
    assert int((~got & p["valid"]).sum()) > 0
    m = Metrics(quiet=True)
    alias = pipeline.simplify_device(*args, m, with_links=with_links)
    assert torch.equal(alias[0] if with_links else alias, got)
    rounds = [e for e in m.events if e["event"] == "simplify_round"]
    assert len(rounds) > 1 and rounds[-1]["alive"] == int(
        (got & p["valid"]).sum())


@pytest.mark.parametrize("cap", [None, 2])
def test_emission_matches_jax(cap):
    """Device emission (cap=2 forces the exact-size retry) and host
    emission in the port equal the JAX package's device emission."""
    from genome_tpu.graph.contigs import emit_contigs_device as jax_emit
    from genome_tpu_torch.graph.contigs import (emit_contigs,
                                                emit_contigs_device)
    j, p, params, cap_nodes = _error_graph(seed=23, glen=1000)
    jalive = jsimp.simplify_device(j["succ"], j["okh"], j["okl"], j["cnt"],
                                   jnp.ones((cap_nodes,), jnp.bool_),
                                   j["valid"], params)
    pfs = _assert_final_equal(j, p, jalive)
    jfs = jsimp.final_chain_state(j["succ"], j["okh"], j["okl"], j["cnt"],
                                  jalive, j["valid"])
    want = jax_emit(jfs, j["okh"], j["okl"], params.k)
    assert emit_contigs_device(pfs, p["okv"], params.k, contig_cap=cap) \
        == want
    assert emit_contigs(pfs, p["okv"], params.k) == want and len(want) > 1


@pytest.mark.parametrize("cap", [None, 1])
def test_emission_ragged_node_count_equals_host(cap):
    """A node count that is no multiple of 16 (the packed base words are
    padded) and a start buffer too small for the contigs (cap=1: the exact
    retry) give the host emission's contigs."""
    from genome_tpu_torch.graph.contigs import (emit_contigs,
                                                emit_contigs_device)
    rng = np.random.default_rng(3)
    n2 = 37
    head = np.full(n2, -1, np.int32)
    dist = np.zeros(n2, np.int32)
    head[:12], dist[:12] = 4, (np.arange(12) - 4) % 12  # chain, head 4
    head[20:29], dist[20:29] = 28, np.arange(9)[::-1]   # chain, head 28
    head[30], head[31] = 30, 31                         # two singletons
    primary = np.zeros(n2, bool)
    primary[[4, 28, 30]] = True                         # 31: not primary
    fs = dict(head=torch.from_numpy(head), dist=torch.from_numpy(dist),
              primary=torch.from_numpy(primary),
              alive_o=torch.from_numpy(head >= 0))
    okv = torch.from_numpy(rng.integers(0, 1 << 18, n2, dtype=np.int64))
    want = emit_contigs(fs, okv, 9)
    assert len(want) == 3
    assert emit_contigs_device(fs, okv, 9, contig_cap=cap) == want


def _chain_state(seqs, primary, k, n2, rng, node_primary=False):
    """A final chain state holding each sequence as one chain of k-mers
    (node m: seq[m : m + k], dist m), at random node ids among n2 (the
    rest dead); primary[i] flags sequence i's head, or each of its nodes
    when node_primary."""
    from genome_tpu_torch.utils import dna
    ids = iter(rng.permutation(n2))
    head = np.full(n2, -1, np.int32)
    dist = np.zeros(n2, np.int32)
    prim = np.zeros(n2, bool)
    okv = rng.integers(0, 1 << (2 * k), n2, dtype=np.int64)
    for seq, p in zip(seqs, primary):
        nodes = [next(ids) for _ in range(len(seq) - k + 1)]
        head[nodes], dist[nodes] = nodes[0], np.arange(len(nodes))
        okv[nodes] = [dna.str_to_kmer(seq[m : m + k])
                      for m in range(len(nodes))]
        prim[nodes if node_primary else nodes[0]] = p
    return dict(head=torch.from_numpy(head), dist=torch.from_numpy(dist),
                primary=torch.from_numpy(prim),
                alive_o=torch.from_numpy(head >= 0)), torch.from_numpy(okv)


# (k, special sequences, emit_contigs_device keywords); random sequences of
# 5-40 bases join each case, and "empty" flags no head primary
_EMIT_CASES = {
    "revcomp_smaller": (5, ["TTTTTACG", "GGGTTTTT"], {}),
    "even_palindrome": (5, ["AACCGGTT", "GAATTC" * 2, "ACGCGT"], {}),
    # mirrored outside, first mismatch at j = 9 > k: forward, then reversed
    "mismatch_past_k": (5, ["AAACCCGGTGAACCGGGTTT", "AAACCCGGTTCACCGGGTTT"],
                        {}),
    "single_node": (7, ["TTTACGA", "ACGTACG", "GATCGAT"], {}),
    "min_contig_len": (5, ["TTTTTT", "ACGTAC" * 4], {"min_contig_len": 12}),
    "node_primary": (5, ["TTTTTACG", "AACCGGTT"], {"node_primary": True}),
    "exact_retry": (5, ["TTTTTACG", "AACCGGTT"], {"contig_cap": 1}),
    "empty": (5, ["TTTTTACG"], {}),
}


@pytest.mark.parametrize("case", list(_EMIT_CASES))
def test_emission_canonical_bytes_equal_host(case):
    """The device emission's canonical bytes give the host emission's
    contigs on hand-built chain states: a smaller reverse complement, even
    palindromes (written forward), a first forward/reverse mismatch past k,
    single-node contigs, min_contig_len dropping some, per-node primary
    flags, the exact retry and an empty selection. contigs_reversed counts
    the contigs whose reverse complement is smaller, and d2h_bytes the
    bytes copied: every selected contig's bases and 3 int64 a contig."""
    from genome_tpu_torch.assemble.metrics import Metrics
    from genome_tpu_torch.graph.contigs import (emit_contigs,
                                                emit_contigs_device)
    from genome_tpu_torch.utils import dna
    k, special, kw = _EMIT_CASES[case]
    rng = np.random.default_rng(len(case))
    seqs = special + ["".join(rng.choice(list("ACGT"), rng.integers(5, 41)))
                      for _ in range(6)]
    seqs = [s for s in seqs if len(s) >= k]
    primary = [case != "empty" and i % 7 != 6 for i in range(len(seqs))]
    fs, okv = _chain_state(seqs, primary, k, 300, rng,
                           kw.get("node_primary", False))
    chosen = [s for s, p in zip(seqs, primary) if p]
    ml = kw.get("min_contig_len", 0)
    want = sorted(min(s, dna.revcomp_str(s)) for s in chosen if len(s) >= ml)
    assert emit_contigs(fs, okv, k, ml, kw.get("node_primary", False)) == want
    m = Metrics(quiet=True)
    with m.phase("contigs"):
        got = emit_contigs_device(fs, okv, k, **kw)
    assert got == want
    assert (case == "empty") == (not want)
    if case == "min_contig_len":
        assert len(want) < len(chosen)
    end = next(e for e in m.events if e["event"] == "phase_end")
    assert end.get("contigs_reversed", 0) == sum(
        dna.revcomp_str(s) < s for s in chosen)
    assert end.get("d2h_bytes", 0) == sum(map(len, chosen)) + 24 * len(chosen)
    assert end["syncs"] <= 3
