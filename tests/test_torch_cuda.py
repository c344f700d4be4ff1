"""The `cuda` lane: the port's CUDA kernels and its main path on the
card, held against the plain versions on the same inputs (exact: integer
outputs). Skips without a card; the fixture decides, never import time.

On a machine with the card:
    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
--noconftest skips tests/conftest.py, which imports JAX, and this file
imports nothing of JAX, so the lane needs only torch there.
"""

import collections
import functools
import json
import warnings

import numpy as np
import pytest
import torch

from genome_tpu_torch.assemble import cli, pipeline
from genome_tpu_torch.assemble.metrics import Metrics
from genome_tpu_torch.assemble.pipeline import extract_stream, run_pipeline
from genome_tpu_torch.io import random_genome, simulate_reads
from genome_tpu_torch.kernels import (bitonic, compact, extract, hist,
                                      partition)
from genome_tpu_torch.kernels.extract import (extract_canonical_kmers,
                                              pack_codes_host, pack_reads)
from genome_tpu_torch.kernels.keys import SENTINEL
from genome_tpu_torch.kernels.mergesort import sort_pairs_merge
from genome_tpu_torch.params import AssemblyParams


@pytest.fixture
def cuda_device():
    """The CUDA card, or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest -m cuda "
                    "--noconftest tests/test_torch_cuda.py)")
    return torch.device("cuda")


def _tiles(x, tile):
    """A size given as an int, or as (m, d) for m tiles plus d."""
    return x if isinstance(x, int) else x[0] * tile + x[1]


def _compact_case(dev, n, p, types, offset, seed):
    """Flags at density p and payloads of `types` ("l" int64, "i" int32),
    each a view `offset` elements into its storage when offset > 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flags = (torch.rand(n + offset, device=dev, generator=g) < p)[offset:]
    arrays = tuple(torch.randint(-2**31, 2**31 - 1, (n + offset,),
                                 device=dev, generator=g,
                                 dtype={"l": torch.int64, "i": torch.int32}[t]
                                 )[offset:] for t in types)
    return flags, arrays


def _assert_compact_equal(flags, arrays, cap, got):
    want = compact.compact_flagged_ref(flags, arrays, cap)
    torch.cuda.synchronize()
    assert int(got[2]) == int(want[2]) and bool(got[3]) == bool(want[3])
    m = min(int(want[2]), cap)
    for a, b in zip(got[0] + (got[1],), want[0] + (want[1],)):
        assert torch.equal(a[:m], b[:m])


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,types,cap,offset", [
    (0, 0.5, "l", 16, 0), (1, 1.0, "l", 1, 0), (1025, 0.5, "li", 2048, 0),
    (1025, 0.0, "l", 2048, 0), (1025, 1.0, "l", 2048, 0),
    (100_000, 0.5, "l", 1000, 0), (12_305, 0.3, "lilili", 50_000, 0),
    (3_000_000, 0.1, "li", 1 << 20, 0),
    # flag and payload views at offsets 1, 3 and 8
    (100_000, 0.5, "li", 1 << 17, 1), (100_000, 0.5, "il", 1 << 17, 3),
    (100_000, 0.3, "l", 1 << 17, 8), ((1, 1), 1.0, "i", (2, 0), 1),
    # n at a tile +- 1, and one past (and short of) a 16-flag vector
    ((1, 1), 0.5, "li", (2, 0), 0), ((1, -1), 0.5, "il", (1, 0), 0),
    ((4, 1), 0.5, "l", (4, 0), 0), ((4, -1), 1.0, "i", (4, 0), 3),
    (17, 1.0, "l", 32, 0), (15, 1.0, "i", 32, 3),
    # the capacity cut in the middle of a tile
    ((5, 0), 0.5, "li", (1, 77), 0), ((5, 0), 1.0, "l", (2, 4096), 0),
    # a look-back across thousands of tiles
    (50_000_000, 0.5, "l", 1 << 26, 0)]
    # every payload set from 0 to 6 arrays, int32 and int64 mixed
    + [(300_001, 0.4, t, 1 << 17, 0)
       for t in ("", "i", "li", "ili", "llii", "iliil", "lilili")])
def test_compact_kernel_matches_plain_on_card(cuda_device, n, p, types, cap,
                                              offset):
    tile = int(compact._lib().compact_tile_size())
    n, cap = _tiles(n, tile), _tiles(cap, tile)
    flags, arrays = _compact_case(cuda_device, n, p, types, offset, n)
    got = compact.compact_flagged(flags, arrays, cap)
    _assert_compact_equal(flags, arrays, cap, got)


@pytest.mark.cuda
@pytest.mark.parametrize("site,n,p,types,cap", [
    # dist_kills: a rank's killed canonicals, compacted to _KILL_MD slots
    # (no payload: the positions are the ids); capacity 2 is the tests'
    # forced overflow
    ("dist_kills", 1 << 10, 0.01, "", 4096),
    ("dist_kills", 1 << 16, 0.05, "", 4096),
    ("dist_kills", 1 << 16, 0.001, "", 2),
    ("dist_kills", 1 << 14, 0.5, "", 4096),
    # dist_bubble_cands: the candidate heads with p, s, coverage, okv and
    # the head id
    ("dist_bubble_cands", 1 << 11, 0.05, "iilli", 4096),
    ("dist_bubble_cands", 1 << 16, 0.02, "iilli", 4096),
    ("dist_bubble_cands", 1 << 16, 0.001, "iilli", 2),
    ("dist_bubble_cands", 1 << 14, 0.5, "iilli", 4096)])
def test_compact_at_the_sharded_simplify_sites(cuda_device, site, n, p,
                                               types, cap):
    flags, arrays = _compact_case(cuda_device, n, p, types, 0, n + cap)
    got = compact.compact_flagged(flags, arrays, cap, site=site)
    _assert_compact_equal(flags, arrays, cap, got)
    assert bool(got[3]) == (int(flags.sum()) > cap)


@pytest.mark.cuda
@pytest.mark.parametrize("site,n,p,types,cap", [
    # dist_emit_blocks: the owner's sorted records, a flag at each block's
    # first (a block holds up to 1024 records), with its (head, block);
    # n = S * ecap, capacity block_cap (legacy at P = 1: 11,324,685 and
    # 15,155)
    ("dist_emit_blocks", 11_324_685, 1 / 1024, "ii", 15_155),
    ("dist_emit_blocks", 1 << 16, 0.01, "ii", 4160),
    ("dist_emit_blocks", 1 << 16, 0.01, "ii", 8),
    # dist_emit_heads: the routed head records (id, k-mer's two words);
    # n = S * hcap_send, capacity head_cap
    ("dist_emit_heads", 2_831_171, 0.001, "iii", 15_155),
    ("dist_emit_heads", 1 << 14, 0.05, "iii", 4160),
    ("dist_emit_heads", 1 << 14, 0.05, "iii", 8)])
def test_compact_at_the_sharded_emission_sites(cuda_device, site, n, p,
                                               types, cap):
    flags, arrays = _compact_case(cuda_device, n, p, types, 0, n + cap)
    compact.reset_launches()
    got = compact.compact_flagged(flags, arrays, cap, site=site)
    _assert_compact_equal(flags, arrays, cap, got)
    assert bool(got[3]) == (int(flags.sum()) > cap)
    assert compact.LAUNCHES[site] == 1


@pytest.mark.cuda
def test_compact_back_to_back_and_on_a_side_stream(cuda_device):
    """Three calls of different n back to back on one stream, then one on
    a side stream whose input is made there just before the call: every
    result exact. Look-back words left from an earlier call, or a launch
    on another stream than the current one, would break one of them."""
    cases = [(2_000_000, 0.3, "li", 1 << 20, 0),
             (70_000, 0.9, "l", 1 << 16, 1), (5_000_000, 0.05, "", 1 << 18, 0)]
    inputs = [_compact_case(cuda_device, n, p, t, off, seed)
              for seed, (n, p, t, _, off) in enumerate(cases)]
    got = [compact.compact_flagged(f, a, c[3])
           for (f, a), c in zip(inputs, cases)]
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flags = ~inputs[0][0]
        arrays = tuple(a + 1 for a in inputs[0][1])
        side_got = compact.compact_flagged(flags, arrays, cases[0][3])
    torch.cuda.synchronize()
    for (f, a), c, g in zip(inputs, cases, got):
        _assert_compact_equal(f, a, c[3], g)
    _assert_compact_equal(flags, arrays, cases[0][3], side_got)


@pytest.mark.cuda
def test_pipeline_on_card_equals_cpu(cuda_device):
    reads = simulate_reads(random_genome(3000, seed=123), read_len=100,
                           coverage=25, error_rate=0.01, seed=7)
    params = AssemblyParams(k=21, min_coverage=2)
    compact.reset_launches()
    got = run_pipeline(reads, params, device=cuda_device)["contigs"]
    assert got == run_pipeline(reads, params, device="cpu")["contigs"]
    assert all(compact.LAUNCHES[s] > 0 for s in compact.SITES
               if s != "tails" and not s.startswith("dist_"))


def _upload_codes(n_rate, seed, rows=300_001, L=101):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(rows, L), dtype=np.uint8)
    codes[rng.random((rows, L)) < n_rate] = 4
    return codes


@pytest.fixture
def pinned_uploads(monkeypatch):
    """Records, for each chunk the pipeline packs, whether its host
    tensors were pinned and whether the mask went along."""
    seen = []
    pack = pipeline.pack_codes_host

    def spy(codes, pin_memory=False):
        packed, invalid, has_invalid = pack(codes, pin_memory=pin_memory)
        seen.append((packed.is_pinned() and invalid.is_pinned(),
                     has_invalid))
        return packed, invalid, has_invalid
    monkeypatch.setattr(pipeline, "pack_codes_host", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("n_rate", [0.0, 0.001])
def test_packed_uploads_equal_uint8_upload(cuda_device, pinned_uploads,
                                           n_rate):
    """Packed with the mask (N's), packed without it (none) and the plain
    uint8 upload give one key stream, across four chunks (the last of one
    row), from pinned host tensors; and the CPU's."""
    codes = _upload_codes(n_rate, 7)
    got = extract_stream(codes, 21, cuda_device, chunk_rows=100_000)
    assert pinned_uploads == [
        (True, bool((codes[i : i + 100_000] >= 4).any()))
        for i in range(0, codes.shape[0], 100_000)]
    assert any(m for _, m in pinned_uploads) == (n_rate > 0)
    want = extract_canonical_kmers(torch.from_numpy(codes).to(cuda_device),
                                   21)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), extract_stream(codes, 21, "cpu",
                                                 chunk_rows=100_000))


@pytest.mark.cuda
def test_packed_upload_chunks_not_corrupted_by_buffer_reuse(
        cuda_device, pinned_uploads):
    """The stream waits behind a long sleep, so every chunk's copy is
    still queued while the host packs the next chunks: a pinned block
    handed out again before its copy ran would corrupt the keys."""
    codes = _upload_codes(0.001, 8, rows=400_000)
    want = extract_stream(codes, 21, "cpu", chunk_rows=50_000)
    pinned_uploads.clear()
    for _ in range(3):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of GPU cycles
        got = extract_stream(codes, 21, cuda_device, chunk_rows=50_000)
        assert torch.equal(got.cpu(), want)
    assert len(pinned_uploads) == 24 and all(p for p, _ in pinned_uploads)


def _packed_on_card(dev, B, L, masked, seed, offset=0):
    """pack_codes_host's tensors of random codes (N's where masked) on the
    card, each a view `offset` bytes into its storage."""
    codes = _upload_codes(0.01 if masked else 0.0, seed, rows=B, L=L)
    if masked:
        codes[0, 0] = 4
    out = []
    for t in pack_codes_host(codes)[:2]:
        buf = torch.zeros(t.numel() + offset, dtype=torch.uint8, device=dev)
        buf[offset:] = t.reshape(-1).to(dev)
        out.append(buf[offset:].view(t.shape))
    return out[0], out[1] if masked else None


# every (k, L) of the CPU tests' grid, with and without the mask, then
# rows of more than one tile of windows (cut into segments), inputs at
# odd byte offsets, one window a row, and k = 1
_EXTRACT_CASES = [(1000, L, k, m, 0) for k in (15, 21, 31)
                  for L in (k, k + 1, 37, 100, 101, 150)
                  for m in (False, True)] + [
    (3, 9000, 31, True, 0), (3, 9000, 31, False, 5), (1, 4126, 31, True, 3),
    (2, 8212, 21, False, 1), (5000, 31, 31, True, 0), (1, 150, 31, True, 7),
    (1000, 150, 31, True, 1), (1000, 100, 21, False, 3), (5, 7, 1, True, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,k,masked,offset", _EXTRACT_CASES)
def test_extract_kernel_matches_plain_on_card(cuda_device, B, L, k, masked,
                                              offset):
    packed, invalid = _packed_on_card(cuda_device, B, L, masked, B + L + k,
                                      offset)
    extract.reset_launches()
    got = extract.extract_canonical_kmers_packed(packed, invalid, k, L)
    want = extract.extract_canonical_kmers_packed_ref(packed, invalid, k, L)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (B * (L - k + 1),)
    assert torch.equal(got, want)
    assert extract.LAUNCHES == {"mask" if masked else "nomask": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [1 << 18, 50_000, 49_999, 4097])
def test_extract_stream_chunk_boundaries_on_card(cuda_device, chunk_rows):
    """Chunks written into their slices of one stream, the last one
    short, with and without N's, equal the CPU's stream; one launch a
    chunk, and one `extract_chunks` a chunk in the count phase."""
    codes = _upload_codes(0.0005, 9, rows=120_001, L=150)
    want = extract_stream(codes, 31, "cpu", chunk_rows=chunk_rows)
    extract.reset_launches()
    m = Metrics(quiet=True)
    with m.phase("count"):
        got = extract_stream(codes, 31, cuda_device, chunk_rows=chunk_rows)
    assert torch.equal(got.cpu(), want)
    n_chunks = -(-codes.shape[0] // chunk_rows)
    assert sum(extract.LAUNCHES.values()) == n_chunks
    end = next(e for e in m.events if e["event"] == "phase_end")
    assert end["extract_chunks"] == n_chunks


@pytest.mark.cuda
def test_extract_kernel_behind_a_device_sleep(cuda_device):
    """Chunks queued behind a long sleep, written into slices of one
    stream by the kernel: the later chunks' inputs, freed and allocated
    again on the host and the device, must not reach the earlier
    chunks' keys. The string path, which packs each batch the same way,
    equals the code matrix's stream."""
    codes = _upload_codes(0.001, 10, rows=200_000, L=101)
    want = extract_stream(codes, 21, "cpu", chunk_rows=30_000)
    for _ in range(2):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of GPU cycles
        got = extract_stream(codes, 21, cuda_device, chunk_rows=30_000)
        assert torch.equal(got.cpu(), want)
    reads = ["".join("ACGTN"[c] for c in row) for row in codes[:3000]]
    torch.cuda._sleep(200_000_000)
    got = extract_stream(reads, 21, cuda_device, batch_reads=700)
    assert torch.equal(got.cpu(), want[: 3000 * 81])


@pytest.mark.cuda
def test_extract_launches_equal_chunks_on_run_pipeline(cuda_device,
                                                       monkeypatch):
    """run_pipeline's count extracts every chunk by the kernel, and its
    count phase says so; the contigs are the CPU's."""
    codes = pack_reads(_sim3kb())
    params = AssemblyParams(k=21, min_coverage=2)
    monkeypatch.setattr(pipeline, "extract_stream", functools.partial(
        pipeline.extract_stream, chunk_rows=100))
    want = run_pipeline(codes, params, device="cpu")["contigs"]
    extract.reset_launches()
    m = Metrics(quiet=True)
    got = run_pipeline(codes, params, metrics=m, device=cuda_device)
    assert got["contigs"] == want
    n_chunks = -(-codes.shape[0] // 100)
    assert extract.LAUNCHES == {"nomask": n_chunks}
    ends = {e["phase"]: e for e in m.events if e["event"] == "phase_end"}
    assert ends["count"]["extract_chunks"] == n_chunks


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dtype", "width", "mask_shape",
                                  "mask_device", "out_device", "out_size",
                                  "k"])
def test_extract_kernel_refuses_what_it_does_not_take(cuda_device, case):
    packed, invalid = _packed_on_card(cuda_device, 8, 40, True, 1)
    args = dict(packed=packed, invalid=invalid, k=21, L=40, out=None)
    args.update({
        "dtype": dict(packed=packed.to(torch.int16)),
        "width": dict(L=44),
        "mask_shape": dict(invalid=invalid[:4].contiguous()),
        "mask_device": dict(invalid=invalid.cpu()),
        "out_device": dict(out=torch.empty(160, dtype=torch.int64)),
        "out_size": dict(out=torch.empty(161, dtype=torch.int64,
                                         device=cuda_device)),
        "k": dict(k=0)}[case])
    extract.reset_launches()
    with pytest.raises(ValueError):
        extract.extract_canonical_kmers_packed(**args)
    assert not extract.LAUNCHES


def _bitonic_case(dev, block, nblocks, dtypes, fill, seed):
    """Arrays for the bitonic kernels: keys by `fill` (random, ties,
    equal, sentinel rows), payloads random."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n = block * nblocks
    hi = {"random": 2**31 - 1, "ties": 3, "equal": 1, "sentinel": 2**31 - 1}
    out = []
    for dt in dtypes:
        a = torch.randint(0, hi[fill], (n,), generator=g, device=dev,
                          dtype=dt)
        if fill == "sentinel" and dt == torch.int64:
            a[::5] = SENTINEL
        out.append(a)
    return tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("block,nblocks,dtypes,num_keys,fill", [
    (256, 8, (torch.int64,), 1, "random"),
    ("tile", 3, (torch.int64,), 1, "random"),       # block == TILE
    ("4tile", 2, (torch.int64, torch.int32), 1, "ties"),  # block > TILE
    (65536, 1, (torch.int64,), 1, "sentinel"),       # one block
    (1024, 4, (torch.int32, torch.int64, torch.int32, torch.int64), 2,
     "ties"),                                        # 2 keys + payloads
    (512, 4, (torch.int64, torch.int32), 1, "equal"),
    (2048, 2, (torch.int32,) * 2, 1, "random"),      # block < TILE
    ("4tile", 2, (torch.int64, torch.int32, torch.int64), 1, "ties"),
    ("4tile", 2, (torch.int64, torch.int64, torch.int32, torch.int64), 2,
     "ties")]                                        # 2 int64 keys + payloads
    # one int64 key at every block size from 2^8 to 2^17: the in-thread,
    # in-warp, cross-warp and cross-tile stages of the network
    + [(1 << b, 2, (torch.int64,), 1, "random") for b in range(8, 18)])
def test_bitonic_kernels_match_plain_on_card(cuda_device, block, nblocks,
                                             dtypes, num_keys, fill):
    probe = (torch.zeros(1, dtype=dt) for dt in dtypes)
    tile = bitonic.tile_size(tuple(probe), 1 << 30)
    block = {"tile": tile, "4tile": 4 * tile}.get(block, block)
    arrays = _bitonic_case(cuda_device, block, nblocks, dtypes, fill, block)
    for fn, ref in ((bitonic.sort_blocks, bitonic.sort_blocks_ref),
                    (bitonic.merge_blocks, bitonic.merge_blocks_ref)):
        got = fn(arrays, num_keys, block)
        want = ref(arrays, num_keys, block)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _hist_keys(dev, n, fill, seed):
    """int64 keys below 2^42 by `fill` (random, sorted, equal), every
    seventh a sentinel or near-sentinel key for `sentinel`, 90 % of them
    one key at random places for `hot`."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    keys = torch.randint(0, 1 << 42, (n,), generator=g, device=dev)
    if fill == "sorted":
        keys = torch.sort(keys).values
    elif fill == "equal":
        keys[:] = 12345
    elif fill == "sentinel":
        keys[::7] = SENTINEL - torch.randint(0, 3000, keys[::7].shape,
                                             generator=g, device=dev)
    elif fill == "hot":
        keys[torch.rand(n, generator=g, device=dev) < 0.9] = 0x2A5A5A5A5A5
    return keys


def _assert_hist_equal(keys, nbits, shift, got):
    want = hist.digit_histogram_ref(keys, nbits, shift)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got.sum()) == keys.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("n,nbits,shift,fill,offset", [
    (0, 8, 0, "random", 0), (5, 8, 0, "random", 0),
    (1, 4, 0, "random", 1),                 # one key, misaligned
    (100_001, 10, 32, "random", 1),         # odd length, misaligned
    (3_000_000, 10, 32, "sorted", 0),       # whole warps in one bin
    (1_000_000, 8, 0, "equal", 0),
    (1_000_000, 8, 56, "sentinel", 0),      # the digit covers bit 63
    (1_000_000, 1, 63, "sentinel", 0),
    (1_000_000, 13, 29, "random", 0),       # 32 KB of counters a block
    (1_000_000, 16, 0, "random", 0),        # the pair cluster
    (1_000_000, 16, 26, "sorted", 0),
    # 90 % of the keys in one bin, at random places
    (3_000_000, 10, 32, "hot", 0), (3_000_000, 16, 26, "hot", 0),
    (3_000_000, 8, 56, "sentinel", 0),
    (1_000_000, 14, 0, "random", 0),        # 64 KB of counters a block
    (1_000_000, 15, 20, "random", 0),       # 128 KB, one block an SM
    # the pair cluster at a few keys and misaligned
    (1, 16, 0, "random", 0), (31, 16, 0, "random", 0),
    (33, 16, 0, "random", 0), (100_001, 16, 0, "random", 1),
    (1_000_000, 5, 37, "random", 0), (1_000_000, 2, 0, "random", 0),
    # a partial last step (a step is some thousands of keys), blocks and
    # pairs with no whole step, a partial last pair
    (41_037, 10, 32, "random", 0), (41_037, 15, 3, "random", 1),
    (41_037, 16, 20, "random", 0), (41_037, 16, 3, "random", 1)])
def test_hist_kernel_matches_plain_on_card(cuda_device, n, nbits, shift,
                                           fill, offset):
    keys = _hist_keys(cuda_device, n + offset, fill, n)[offset:]
    hist.reset_launches()
    got = hist.digit_histogram(keys, nbits, shift)
    _assert_hist_equal(keys, nbits, shift, got)
    assert hist.LAUNCHES["digit_histogram"] == (1 if n else 0)


@pytest.mark.cuda
def test_hist_back_to_back_and_on_a_side_stream(cuda_device):
    """Calls at 8, 13 and 16 bits back to back on one stream, each into a
    fresh output, then one on a side stream whose keys are made there just
    before the call: every result exact. An output zeroed on another
    stream than the launch's, or counters left from an earlier call,
    would break one of them."""
    cases = [(2_000_000, 8, 0, "random", 0), (70_001, 13, 29, "hot", 1),
             (3_000_000, 16, 26, "random", 0)]
    inputs = [_hist_keys(cuda_device, n + off, fill, seed)[off:]
              for seed, (n, _, _, fill, off) in enumerate(cases)]
    got = [hist.digit_histogram(k, c[1], c[2]) for k, c in zip(inputs, cases)]
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        keys = inputs[2] * 3 + 1
        side_got = hist.digit_histogram(keys, 16, 20)
    torch.cuda.synchronize()
    for k, c, g in zip(inputs, cases, got):
        _assert_hist_equal(k, c[1], c[2], g)
    _assert_hist_equal(keys, 16, 20, side_got)


def _assert_partition_equal(got, want, cap):
    out, totals, ovf = got
    rout, rtotals, rovf = want
    assert torch.equal(totals, rtotals) and bool(ovf) == bool(rovf)
    kept = torch.arange(cap, device=out.device) \
        < totals.clamp(max=cap).unsqueeze(1)
    assert torch.equal(out[kept], rout[kept])


def _partition_case(dev, n, B, bids, dtypes, offset, tile, seed):
    """bid and rem by `bids` (random, one, out of range, hot0: 90 % in
    bucket 0, sorted, sparse: odd tiles use only the lowest third of the
    buckets, tail: the last eight tiles all in bucket B - 1), each a view
    `offset` elements into its storage when offset > 0."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    lo, hi = (-3, B + 3) if bids == "out of range" else (0, B)
    bid = torch.randint(lo, hi, (n + offset,), generator=g, device=dev,
                        dtype=dtypes[0])
    if bids == "one":
        bid[:] = B - 1
    elif bids == "hot0":
        bid[torch.rand(n + offset, generator=g, device=dev) < 0.9] = 0
    elif bids == "sorted":
        bid = torch.sort(bid).values
    elif bids == "sparse":
        odd = (torch.arange(n + offset, device=dev) - offset) // tile % 2 == 1
        bid[odd] %= B // 3 + 1
    elif bids == "tail":
        bid[-8 * tile:] = B - 1
    rem = torch.randint(-2**31, 2**31 - 1, (n + offset,), generator=g,
                        device=dev, dtype=dtypes[1])
    return bid[offset:], rem[offset:]


I32, I64 = (torch.int32, torch.int32), (torch.int64, torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,cap,bids,dtypes,offset", [
    (0, 4, 1024, "random", I32, 0),
    (1000, 8, 2048, "random", I32, 0),                  # < one tile
    (200_000, 5, 201_728, "one", I32, 0),
    (200_000, 1, 201_728, "random", (torch.int32, torch.int64), 0),
    (300_000, 4, 100_352, "out of range", I32, 0),
    (300_000, 4, 8192, "hot0", I32, 0),                 # overflow
    (500_000, 1025, 2048, "random", I64, 0),
    (1_000_000, 1025, 4096, "sorted", I32, 0),
    # long look-back chains; buckets empty in every other tile
    ((300, 0), 2, None, "random", I32, 0),
    ((400, 3), 1025, None, "sparse", I32, 0),
    ((200, 5), 4096, None, "sparse", (torch.int32, torch.int64), 0),
    ((150, 0), 4096, None, "random", I64, 0),
    # whole tiles of one bucket after random ones (the sentinel tail)
    ((40, 0), 1025, None, "tail", I32, 0),
    # n one short of and one past a tile multiple
    ((7, -1), 9, None, "random", I32, 0),
    ((7, 1), 9, None, "random", (torch.int64, torch.int32), 0),
    # views bid[1:], rem[1:] of both widths
    ((5, 3), 7, None, "random", I32, 1),
    ((5, 3), 7, None, "random", I64, 1),
    ((5, 3), 1025, None, "out of range", (torch.int32, torch.int64), 1),
    # the cap reached in the middle of a tile
    ((4, 0), 4, 8192, "hot0", (torch.int64, torch.int64), 0)])
def test_partition_kernel_matches_plain_on_card(cuda_device, n, B, cap, bids,
                                                dtypes, offset):
    """cap None: the largest bucket plus one CHUNK, rounded up to CHUNK,
    so that nothing overflows."""
    tile = partition._lib()._tile
    n = _tiles(n, tile)
    bid, rem = _partition_case(cuda_device, n, B, bids, dtypes, offset, tile,
                               n + B)
    if cap is None:
        keep = (bid >= 0) & (bid < B)
        top = int(torch.bincount(bid[keep].long(), minlength=B).max())
        cap = (top // partition.CHUNK + 2) * partition.CHUNK
    partition.reset_launches()
    got = partition.partition_by_bucket(bid, rem, B, cap)
    want = partition.partition_by_bucket_ref(bid, rem, B, cap)
    torch.cuda.synchronize()  # an out-of-bounds write faults here
    _assert_partition_equal(got, want, cap)
    assert bool(got[2]) == (bids == "hot0")
    assert partition.LAUNCHES["partition_by_bucket"] == (1 if n else 0)


@pytest.mark.cuda
def test_partition_back_to_back_and_on_a_side_stream(cuda_device):
    """Three calls of different n and B back to back on one stream, each
    with fresh scratch, then one on a side stream whose input is made there
    just before the call: every result exact. Look-back words or a tile
    counter left from an earlier call, or a launch on another stream than
    the current one, would break one of them."""
    tile = partition._lib()._tile
    cases = [(2_000_000, 1025, 4096, "random", I32, 0),
             (70_000, 3, 71_680, "sparse", I64, 1),
             (3 * tile + 1, 4096, 2048, "random",
              (torch.int32, torch.int64), 0)]
    inputs = [_partition_case(cuda_device, n, B, bids, dt, off, tile, seed)
              for seed, (n, B, _, bids, dt, off) in enumerate(cases)]
    got = [partition.partition_by_bucket(bid, rem, c[1], c[2])
           for (bid, rem), c in zip(inputs, cases)]
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        bid = (inputs[0][0] + 7) % 1025
        rem = inputs[0][1] + 1
        side_got = partition.partition_by_bucket(bid, rem, 1025, 4096)
    torch.cuda.synchronize()
    for (b, r), c, g in zip(inputs, cases, got):
        _assert_partition_equal(g, partition.partition_by_bucket_ref(
            b, r, c[1], c[2]), c[2])
    _assert_partition_equal(side_got, partition.partition_by_bucket_ref(
        bid, rem, 1025, 4096), 4096)


@pytest.mark.cuda
def test_sort_pairs_merge_on_card_equals_torch_sort(cuda_device):
    (keys,) = _bitonic_case(cuda_device, 4096, 11, (torch.int64,),
                            "sentinel", 1)
    bitonic.reset_launches()
    got = sort_pairs_merge(keys, block=4096)
    assert torch.equal(got, torch.sort(keys).values)
    assert dict(bitonic.LAUNCHES) == {"sort_blocks": 1, "merge_blocks": 4}


def _sim3kb():
    return simulate_reads(random_genome(3000, seed=123), read_len=100,
                          coverage=25, error_rate=0.01, seed=7)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_DEVICE_CALLS = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset",
                 "cuLaunchKernel", "cuMemcpy", "cuMemset")


@pytest.mark.cuda
def test_profile_keeps_the_first_device_records(cuda_device, tmp_path):
    """`--profile` opens its session with a prologue: the trace holds the
    device record of every compaction launch of the job, the first one
    included, of every device call inside the block, and the spans'
    annotations."""
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(_sim3kb())))
    compact.reset_launches()
    assert cli.main([str(fq), "-o", str(tmp_path / "c.fasta"), "--quiet",
                     "--profile", str(tmp_path / "prof")]) == 0
    launches = sum(compact.LAUNCHES.values())
    with open(tmp_path / "prof" / "trace.json") as f:
        ev = json.load(f)["traceEvents"]
    tiles = [e for e in ev if e.get("cat") == "kernel"
             and e["name"].startswith("compact_tiles")]
    assert launches > 0 and len(tiles) == launches
    block = next(e for e in ev if e.get("cat") == "user_annotation"
                 and e["name"] == pipeline.PROFILE_ANNOTATION)
    device = {e["args"]["correlation"] for e in ev
              if e.get("cat") in _DEVICE_CATS}
    calls = sorted((e for e in ev
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and e["name"].startswith(_DEVICE_CALLS)
                    and block["ts"] <= e["ts"] <= block["ts"] + block["dur"]),
                   key=lambda e: e["ts"])
    lost = [e["name"] for e in calls
            if e["args"].get("correlation") not in device]
    assert calls and not lost
    names = {e["name"] for e in ev if e.get("cat") == "user_annotation"}
    assert {"count.sort", "count.extract", "emit.strings"} <= names


@pytest.mark.cuda
def test_device_spans_and_upload_bytes_on_card(cuda_device):
    """The count's device spans read their device time, within the count
    phase's wall; h2d_bytes is the packed upload; the contigs are the
    CPU's."""
    reads = _sim3kb()
    codes = pack_reads(reads)
    params = AssemblyParams(k=21, min_coverage=2)
    run_pipeline(codes, params, device=cuda_device)  # builds and warms up
    m = Metrics(quiet=True)
    got = run_pipeline(codes, params, metrics=m, device=cuda_device)
    assert got["contigs"] == run_pipeline(codes, params,
                                          device="cpu")["contigs"]
    spans = {e["name"]: e for e in m.events if e["event"] == "span"}
    ends = {e["phase"]: e for e in m.events if e["event"] == "phase_end"}
    device_ms = [spans[n]["device_ms"]
                 for n in ("count.extract", "count.sort", "count.runs")]
    assert all(d is not None and d > 0 for d in device_ms)
    assert sum(device_ms) <= 1e3 * ends["count"]["wall_s"]
    R, L = codes.shape
    assert ends["count"]["h2d_bytes"] == R * -(-L // 4)
    assert sum(e["h2d_bytes"] for e in ends.values()) == R * -(-L // 4)


@pytest.mark.cuda
def test_host_syncs_match_the_sync_debug_warnings(cuda_device, monkeypatch):
    """Under torch.cuda.set_sync_debug_mode("warn") every synchronizing
    operation of a job warns. Each host read is counted in the job's
    `syncs`; the explicit torch.cuda.synchronize() after the build and
    after the final state is counted there too but does not warn. The one
    implicit sync is not a read: graph/simplify.py::_set_drop writing a
    Python scalar into a CUDA tensor copies the scalar from pageable host
    memory and waits for it (one a kill pass, two a degree update, one a
    bubble doom), so the test counts those calls itself."""
    from genome_tpu_torch.graph import simplify as graph_simplify
    codes = pack_reads(_sim3kb())
    params = AssemblyParams(k=21, min_coverage=2)
    run_pipeline(codes, params, device=cuda_device)  # builds and warms up
    scalar_writes = []
    set_drop = graph_simplify._set_drop

    def spy(x, idx, val):
        if not torch.is_tensor(val):
            scalar_writes.append(val)
        return set_drop(x, idx, val)
    monkeypatch.setattr(graph_simplify, "_set_drop", spy)
    m = Metrics(quiet=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_pipeline(codes, params, metrics=m, device=cuda_device)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    warned = [str(w.message) for w in caught
              if str(w.message).startswith("called a synchronizing")]
    ends = [e for e in m.events if e["event"] == "phase_end"]
    sites = collections.Counter()
    for e in ends:
        sites.update(e["sync_sites"])
    explicit = sites["build.sync"] + sites["final.sync"]
    assert explicit == 2 and scalar_writes
    assert len(warned) == (sum(e["syncs"] for e in ends) - explicit
                           + len(scalar_writes)), dict(sites)


@pytest.mark.cuda
def test_emission_canonical_bytes_on_card_equal_host(cuda_device):
    """emit_contigs_device on the card equals emit_contigs on the host on a
    random chain state of 2,000,003 nodes at k = 31 in 3,000 chains (some
    nodes dead, some heads not primary); its phase reads the device three
    times (the counts, the bytes, the meta stack) and synchronizes nowhere
    else; d2h_bytes is those two copies."""
    from genome_tpu_torch.graph.contigs import (emit_contigs,
                                                emit_contigs_device)
    rng = np.random.default_rng(31)
    n2, n_chains, k = 2_000_003, 3000, 31
    perm = rng.permutation(n2)
    bounds = np.sort(rng.choice(np.arange(1, n2), n_chains - 1,
                                replace=False))
    chain = np.zeros(n2, np.int64)
    chain[bounds] = 1
    chain = np.cumsum(chain)               # chain of each slot of perm
    first = np.concatenate([[0], bounds])  # first slot of each chain
    head = np.empty(n2, np.int32)
    dist = np.empty(n2, np.int32)
    head[perm] = perm[first[chain]]
    dist[perm] = np.arange(n2) - first[chain]
    primary = rng.random(n2) < 0.9
    alive_o = rng.random(n2) < 0.999
    okv = rng.integers(0, 1 << (2 * k), n2, dtype=np.int64)
    fs = dict(head=head, dist=dist, primary=primary, alive_o=alive_o)
    want = emit_contigs({n: torch.from_numpy(v) for n, v in fs.items()},
                        torch.from_numpy(okv), k)
    dfs = {n: torch.from_numpy(v).to(cuda_device) for n, v in fs.items()}
    dokv = torch.from_numpy(okv).to(cuda_device)
    emit_contigs_device(dfs, dokv, k)  # warm up
    torch.cuda.synchronize()
    m = Metrics(quiet=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with m.phase("contigs"):
                got = emit_contigs_device(dfs, dokv, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert got == want and len(want) > 2000
    end = next(e for e in m.events if e["event"] == "phase_end")
    assert end["syncs"] == 3 and sum(end["sync_sites"].values()) == 3
    warned = [w for w in caught
              if str(w.message).startswith("called a synchronizing")]
    assert len(warned) == 3
    assert end["d2h_bytes"] == sum(map(len, want)) + 24 * len(want)
    assert 0 < end["contigs_reversed"] < len(want)


@pytest.mark.cuda
def test_sharded_emission_bytes_on_card_equal_host(cuda_device):
    """dist/emit.py::contigs_from_gathered on the card equals the plain
    host decode on gathered rows of S = 4 ranks holding 20,000 chains at
    k = 31 (1 to 4 blocks each, spread over the ranks), whole and in one
    local slice; it reads the device three times (the counts, the bytes,
    the meta stack) and synchronizes nowhere else; d2h_bytes is those two
    copies."""
    from genome_tpu_torch.dist.emit import contigs_from_gathered
    from genome_tpu_torch.utils import dna
    from torch_emit_gathered import gathered_case, host_decode
    rng = np.random.default_rng(14)
    k, n = 31, 20_000
    lens = np.where(rng.random(n) < 0.02, rng.integers(1024, 4096, n),
                    rng.integers(k, 400, n))
    text = dna.decode(rng.integers(0, 4, int(lens.sum()), dtype=np.uint8))
    cuts = np.concatenate([[0], np.cumsum(lens)])
    seqs = [text[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    rows = gathered_case(seqs, 4, k, seed=14)
    want = host_decode(*rows, k)
    drows = [torch.from_numpy(x).to(cuda_device) for x in rows]
    assert contigs_from_gathered(*drows, k, 0, (1, 4)) == host_decode(
        *rows, k, 0, (1, 4))
    torch.cuda.synchronize()
    m = Metrics(quiet=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with m.phase("dist_contigs"):
                got = contigs_from_gathered(*drows, k)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert got == want and len(want) == n
    end = next(e for e in m.events if e["event"] == "phase_end")
    assert end["sync_sites"] == {"dist_emit.counts": 1, "dist_emit.bases": 1,
                                 "dist_emit.meta": 1}
    warned = [w for w in caught
              if str(w.message).startswith("called a synchronizing")]
    assert len(warned) == 3
    assert end["d2h_bytes"] == sum(map(len, want)) + 24 * n
    assert 0 < end["contigs_reversed"] < n
