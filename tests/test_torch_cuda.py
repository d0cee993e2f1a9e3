"""The port's hand-written CUDA kernels on the card, with no JAX import, so
that the file runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: segment-min byte-equal (a min is exact in any order; -0.0 is
mapped to +0.0 first), segment-sum within rtol 1e-5 / atol 1e-4 (the
tolerance of ``tests/test_kernels.py``: float atomics add in an order that
changes from run to run), or byte-equal where every partial sum is exact.
The analytics test runs one store on the card and one on the CPU from the
same stream.  The batched search must equal its plain version exactly
(integers).  Attention is held against the plain version on the same
inputs upcast to float32: rtol 1e-3 / atol 2e-3 in float32 (the tolerance
of ``tests/test_kernels.py``), atol 2e-2 in bfloat16 and float16, where the
output is rounded to 8 or 11 significant bits; the tensor-core kernel is
also held elementwise to 2^-7 |want| + 1e-4 (``chip_smoke.py``'s bf16
limit: twice bfloat16's rounding of the output plus a floor for float32
summation over the keys).  The multi-run segment sum must equal its plain
version where every partial sum is an exact float32 integer, and match
within rtol 1e-5 / atol 1e-4 on real-valued x.  The merge-path
permutation and the batched tournament round (keys and payload moved,
never computed) must equal their plain versions exactly, and a store's
spine built on the card must equal the CPU store's.  A durable store on
the card must reload evicted runs from their segment files byte-equal to
the tensors it evicted, read the same after a reopen, order a prefetched
run's upload before a reader on another thread (20 times), and serve
``ConcurrentLSMGraph`` snapshots equal to the oracle at each τ.  Four
durable shards on the card must read equal to the oracle at each sharded
snapshot's per-shard τs, launch ``merge_pairs`` exactly once a round of
every shard's spine across the pool's threads, and reopen onto the card.
Two gloo ranks sharing the card must give the single-store PageRank within
1e-5 of its largest rank, through ``gather_segsum`` once a rank an
iteration.  The LM serving path (``chip_smoke.py`` phase 12 at reduced
width): each family's prefill and decode steps on the card within
rtol = atol = 1e-3 of the CPU (float32 weights and cache), and
``flash_attention`` on a model's layer-0 activations (Qwen2-1.5B's heads)
launched once on the tensor cores, held as phase 12 (d) holds it.  The
LM training path (phase 13 at reduced width): each family's loss,
gradients and one AdamW update on the card within rtol = atol = 1e-3 of
the CPU (float32); three train steps of reduced qwen2-1.5b on the card
against the CPU (losses within rtol 1e-5, parameters within rtol = atol =
1e-3); ``compress_int8`` byte-equal to the CPU's; a card model and its
AdamW state through a checkpoint and back, bit for bit.  Every test skips
where there is no card.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import analytics  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core import filters  # noqa: E402
from repro_torch.core.store import _stack_presence  # noqa: E402
from repro_torch.core.types import INVALID_VID  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import lookup  # noqa: E402
from repro_torch.kernels import merge  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import presence  # noqa: E402
from repro_torch.kernels import segment_reduce as segred  # noqa: E402

SEG_TOL = dict(rtol=1e-5, atol=1e-4)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _seg_case(seed, e, v, *, min_wt=False, n_out=None):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, v, e)).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if min_wt:
        wt = rng.uniform(0, 2, e).astype(np.float32)
    else:
        wt = rng.choice([1.0, -1.0, 0.0, 2.5], e).astype(np.float32)
    x = rng.normal(size=v).astype(np.float32)
    return dst, seg, wt, x, v if n_out is None else n_out


def _hub_case(rng, e, v, dev):
    """Sorted segments with one hub of more than 1,000,000 edges, empty
    segments, runs crossing every block edge and seg_id >= n_out at the
    tail.  x and wt hold integers of magnitude <= 2, so every partial sum
    is an integer below 2**24, exact in float32: segsum must match in any
    order."""
    hub = 1_200_000
    seg = np.concatenate([np.zeros(3, np.int32), np.full(hub, 2, np.int32),
                          np.sort(rng.integers(3, v + 40, e - hub - 3))
                          ]).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    wt = rng.choice([1.0, -1.0, 0.0, 2.0], e).astype(np.float32)
    x = rng.integers(-2, 3, v).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (dst, seg, wt, x)]


@pytest.mark.cuda
def test_cuda_segment_kernels_match_plain_versions():
    """On the card: segsum and segmin against their plain versions, on the
    CPU tests' sweeps (segsum within SEG_TOL, segmin byte-equal after
    mapping -0.0 to +0.0) and on a hub segment of 1,200,000 edges (exact
    sums: both byte-equal); E = 0 included; each launch counted."""
    dev = _card()
    ops.reset_launches()
    n_calls = 0
    for e, v in [(64, 8), (512, 64), (1000, 300), (513, 7), (2048, 2048),
                 (0, 5), (100_003, 1000)]:
        for kind in ("segsum", "segmin"):
            dst, seg, wt, x, n = _seg_case(e + v, e, v,
                                           min_wt=kind == "segmin",
                                           n_out=max(v - 3, 1))
            args = [torch.from_numpy(a).to(dev) for a in (dst, seg, wt, x)]
            got = getattr(segred, f"gather_{kind}_cuda")(*args, n)
            want = getattr(segred, f"gather_{kind}_ref")(*args, n)
            n_calls += 1
            if kind == "segsum":
                torch.testing.assert_close(got, want, **SEG_TOL)
            else:
                assert torch.equal(got + 0.0, want + 0.0)
    rng = np.random.default_rng(2)
    for kind in ("segsum", "segmin"):
        args = _hub_case(rng, 3_000_000, 50_000, dev)
        got = getattr(segred, f"gather_{kind}_cuda")(*args, 50_000)
        want = getattr(segred, f"gather_{kind}_ref")(*args, 50_000)
        assert torch.equal(got + 0.0, want + 0.0), kind
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"presence_matrix": 0, "merge_perm": 0,
                                   "merge_pairs": 0,
                                   "gather_segsum": n_calls // 2 + 1,
                                   "gather_segmin": n_calls // 2 + 1,
                                   "gather_segsum_runs": 0,
                                   "batched_searchsorted": 0,
                                   "batched_searchsorted_runs": 0,
                                   "flash_attention": 0}


# Segment lengths laid against the single-run kernels' geometry (a warp
# walks 256 edges, 32 a step): ending exactly at, one before and one after
# a step's and a warp range's end; below one step; ragged (the last range
# not a multiple of 32 edges, or a multiple of 32 but not of 64).
SEG_BOUNDARY_CASES = {
    "step": [32] * 200, "step_pm1": [31, 33] * 100,
    "warp": [256] * 40, "warp_pm1": [255, 257] * 20,
    "tiles": [2048] * 3, "below_step": [3, 1, 4, 1, 5, 9, 2],
    "ragged": [1, 2047, 2048 * 3, 5, 13, 2050],
    "end_at_32": [2048, 29],
}


def _boundary_case(lengths, offset, kind, dev, seed):
    """Segments of the given lengths (an empty segment between some),
    behind 2,048 edges of seg_id -1 (segment 0, so the lengths fall on the
    kernels' step and range edges) and ahead of three edges with seg_id >=
    n_out, as contiguous views starting ``offset`` elements into
    their buffers; dst from -3 to past the end of x.  segsum: integer
    inputs (every partial sum exact); segmin: negative values and -0.0."""
    rng = np.random.default_rng(seed)
    ids = np.cumsum(rng.integers(1, 3, len(lengths)))
    seg = np.concatenate([[-1] * 2048, np.repeat(ids, lengths),
                          [ids[-1] + 2] * 3]).astype(np.int32)
    n_out = int(ids[-1]) + 1
    e, v = seg.shape[0], n_out + 5
    dst = rng.integers(-3, v + 3, e).astype(np.int32)
    if kind == "segsum":
        wt = rng.choice([1.0, -1.0, 0.0, 2.0], e).astype(np.float32)
        x = rng.integers(-2, 3, v).astype(np.float32)
    else:
        wt = rng.uniform(-2, 2, e).astype(np.float32)
        wt[rng.integers(0, e, 5)] = -0.0
        x = rng.normal(size=v).astype(np.float32)
        x[rng.integers(0, v, 3)] = -0.0

    def view(a):
        buf = torch.zeros(a.shape[0] + offset, dtype=torch.from_numpy(
            a).dtype, device=dev)
        buf[offset:] = torch.from_numpy(a).to(dev)
        return buf[offset:]

    return [view(dst), view(seg), view(wt),
            torch.from_numpy(x).to(dev)], n_out


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(SEG_BOUNDARY_CASES))
def test_cuda_segment_kernels_at_boundaries(case, offset):
    """Both single-run kernels against their plain versions where segments
    end at step and warp-range edges, on views that start 0 to 12 bytes
    past a 16-byte boundary: byte-equal (segsum on exact integer inputs;
    segmin after mapping -0.0 to +0.0)."""
    dev = _card()
    for kind in ("segsum", "segmin"):
        args, n_out = _boundary_case(SEG_BOUNDARY_CASES[case], offset, kind,
                                     dev, len(case) + offset)
        assert args[0].data_ptr() % 16 == 4 * offset
        got = getattr(segred, f"gather_{kind}_cuda")(*args, n_out)
        want = getattr(segred, f"gather_{kind}_ref")(*args, n_out)
        torch.cuda.synchronize()
        assert torch.equal(got + 0.0, want + 0.0), (kind, case, offset)


@pytest.mark.cuda
def test_cuda_segment_kernels_repeat_byte_equal():
    """20 runs of each single-run kernel give the same bytes every time
    where the result cannot depend on the order of the kernel's atomics:
    segmin always (a min is exact in any order), segsum on the hub case (a
    segment of 1,200,000 edges across many warp ranges), whose integer
    partial sums are exact.  segsum on real values adds a hub's partials by
    atomicAdd in an order that changes: it stays within SEG_TOL."""
    dev = _card()
    rng = np.random.default_rng(12)
    hub = _hub_case(rng, 3_000_000, 50_000, dev)
    real = [torch.from_numpy(a).to(dev) for a in _seg_case(
        5, 500_000, 20_000, n_out=20_000)[:4]]
    for args, n_out, exact in ((hub, 50_000, True), (real, 20_000, False)):
        for kind in ("segsum", "segmin"):
            kern = getattr(segred, f"gather_{kind}_cuda")
            first = kern(*args, n_out)
            for _ in range(20):
                again = kern(*args, n_out)
                if exact or kind == "segmin":
                    assert torch.equal(again.view(torch.int32),
                                       first.view(torch.int32)), kind
                else:
                    torch.testing.assert_close(again, first, **SEG_TOL)


@pytest.mark.cuda
def test_cuda_analytics_match_cpu_store():
    """One stream through a store on the card and one on the CPU: the
    materialized CSRs and multi-level views are byte-equal, BFS, SSSP and CC
    equal, PageRank, SCAN and multi-level PageRank within tolerance; the
    card's run launches both segment kernels."""
    dev = _card()
    cfg = dict(vmax=1 << 12, mem_edges=1 << 10, seg_size=4,
               n_segments=1 << 10, hash_slots=1 << 12, ovf_cap=1 << 12,
               batch_cap=256, l0_run_limit=2, seg_target_edges=1 << 10)
    rng = np.random.default_rng(4)
    key = np.unique(rng.integers(0, 1 << 22, 6000))
    src, dst = key >> 11, key & 2047
    prop = rng.random(len(src)).astype(np.float32)
    stores = [LSMGraph(StoreConfig(**cfg), device=d) for d in (dev, "cpu")]
    for g in stores:
        for lo in range(0, len(src), 1500):
            g.insert_edges(src[lo:lo + 1500], dst[lo:lo + 1500],
                           prop=prop[lo:lo + 1500])
            pick = slice(lo, lo + 100)
            g.delete_edges(src[pick], dst[pick])
    out = []
    ops.reset_launches()
    for g in stores:
        with g.snapshot() as snap:
            view = analytics.materialize_csr(snap, cfg["vmax"])
            views = analytics.multilevel_views(snap)
            res = dict(
                view=view, views=views,
                pr=analytics.pagerank(view, iters=10),
                bfs=analytics.bfs(view, int(src[200])),
                sssp=analytics.sssp(view, int(src[200])),
                cc=analytics.cc(view),
                scan=analytics.scan_stats(view),
                ml=analytics.multilevel_pagerank(views, n_out=cfg["vmax"],
                                                 iters=10))
        out.append(res)
    torch.cuda.synchronize()
    launched = ops.launch_counts()
    assert launched["gather_segsum"] > 0 and launched["gather_segmin"] > 0
    card, cpu = out

    def host(t):
        return t.cpu()

    for f in ("voff", "dst", "prop"):
        assert torch.equal(host(getattr(card["view"], f)),
                           getattr(cpu["view"], f)), f
    assert len(card["views"]) == len(cpu["views"]) >= 2
    for a, b in zip(card["views"], cpu["views"]):
        for f in a._fields:
            assert torch.equal(host(getattr(a, f)), getattr(b, f)), f
    for k in ("bfs", "sssp", "cc"):
        assert torch.equal(host(card[k]) + 0, cpu[k] + 0), k
    pr_tol = dict(rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(host(card["pr"]), cpu["pr"], **pr_tol)
    torch.testing.assert_close(host(card["ml"]), cpu["ml"], **pr_tol)
    torch.testing.assert_close(host(card["ml"]), host(card["pr"]), **pr_tol)
    assert torch.equal(host(card["scan"][0]), cpu["scan"][0])
    torch.testing.assert_close(host(card["scan"][1]), cpu["scan"][1],
                               **SEG_TOL)


@pytest.mark.cuda
def test_cuda_batched_searchsorted_matches_plain_version():
    """The bisection kernel against its plain version: n_keys 0, 1, a
    middle value and the full length (as an int and as a 0-d tensor on the
    card); queries below, between, equal to and above the keys, INVALID_VID
    queries, and query counts that are not multiples of 32."""
    dev = _card()
    rng = np.random.default_rng(7)
    ops.reset_launches()
    n_calls = 0
    for cap, nq in [(1, 1), (64, 33), (1000, 257), (4096, 70_001)]:
        keys = np.sort(rng.choice(1 << 20, cap, replace=False))
        keys = keys.astype(np.int32) * 2           # odd queries fall between
        queries = np.concatenate([
            rng.integers(-5, 2 * (1 << 20) + 5, nq - nq // 2),
            rng.choice(keys, nq // 2), [INVALID_VID, -(1 << 31)]])
        rng.shuffle(queries)
        k = torch.from_numpy(keys).to(dev)
        q = torch.from_numpy(queries.astype(np.int32)).to(dev)
        for n in sorted({0, 1, cap // 2, cap}):
            for n_keys in (n, torch.tensor(n, dtype=torch.int32,
                                           device=dev)):
                got = lookup.batched_searchsorted_cuda(k, q, n_keys)
                want = lookup.batched_searchsorted_ref(k, q, n_keys)
                n_calls += 1
                assert got.dtype == torch.int32
                assert torch.equal(got, want), (cap, nq, n)
                assert int(got.max()) <= n
    padded = torch.full((100,), INVALID_VID, dtype=torch.int32, device=dev)
    padded[:10] = torch.arange(0, 100, 10, device=dev)
    q = torch.tensor([-3, 0, 35, 41, 95, 200], dtype=torch.int32, device=dev)
    for n in (0, 1, 5, 10):
        want = lookup.batched_searchsorted_ref(padded, q, n)
        assert torch.equal(lookup.batched_searchsorted_cuda(padded, q, n),
                           want)
        n_calls += 1
    # The Fig 16 L0 run's shape: 504,073 keys in 4,194,304 slots, where the
    # kernel searches a staged sample and then a window in device memory.
    keys = torch.full((1 << 22,), INVALID_VID, dtype=torch.int32, device=dev)
    keys[:504_073] = torch.from_numpy(np.sort(rng.choice(
        1 << 22, 504_073, replace=False)).astype(np.int32)).to(dev)
    q = torch.cat([torch.from_numpy(rng.integers(
        -5, (1 << 22) + 5, 65_536).astype(np.int32)).to(dev),
        keys[torch.randint(0, 504_073, (64,), device=dev)],
        torch.tensor([INVALID_VID, -(1 << 31)], dtype=torch.int32,
                     device=dev)])
    for n in (504_073, torch.tensor(504_073, dtype=torch.int32, device=dev)):
        assert torch.equal(lookup.batched_searchsorted_cuda(keys, q, n),
                           lookup.batched_searchsorted_ref(keys, q, n))
        n_calls += 1
    torch.cuda.synchronize()
    assert ops.launch_counts()["batched_searchsorted"] == n_calls


def _search_runs(rng, k, dev, *, big=False):
    """k ragged runs laid end to end: capacities of 256 to 4,096 slots
    (every fifth run empty, some full), INVALID_VID past each run's nv; with
    ``big``, run 1 holds 504,073 keys in 4,194,304 slots (the staged-sample
    path).  Returns (keys, int64 offs, int32 nv) on the card."""
    caps = rng.choice([256, 512, 1024, 2048, 4096], k)
    if big and k > 1:
        caps[1] = 1 << 22
    parts, nvs = [], []
    for i, cap in enumerate(caps):
        nv = 0 if i % 5 == 4 else (int(cap) if i % 7 == 3 else
                                   int(rng.integers(1, cap + 1)))
        if big and i == 1:
            nv = 504_073
        part = np.full(cap, INVALID_VID, np.int32)
        part[:nv] = np.sort(rng.choice(1 << 22, nv, replace=False))
        parts.append(part)
        nvs.append(nv)
    offs = np.cumsum([0, *caps[:-1]]).astype(np.int64)
    return (torch.from_numpy(np.concatenate(parts)).to(dev),
            torch.from_numpy(offs).to(dev),
            torch.from_numpy(np.asarray(nvs, np.int32)).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("k,b", [(1, 33), (3, 65_600), (1935, 5_000)])
def test_cuda_batched_searchsorted_runs_matches_plain_version(k, b):
    """The one-launch search into every run against its plain version:
    ragged runs, empty and full ones, a run past the shared-memory stage
    (k > 1), INVALID_VID and INT32_MIN queries, B not a multiple of 32;
    exactly one counted launch a call."""
    dev = _card()
    rng = np.random.default_rng(k)
    keys, offs, nv = _search_runs(rng, k, dev, big=k > 1)
    q = torch.from_numpy(np.concatenate([
        rng.integers(-5, (1 << 22) + 5, b - 2),
        [INVALID_VID, -(1 << 31)]]).astype(np.int32)).to(dev)
    q[: b // 4] = keys[torch.randint(0, keys.shape[0], (b // 4,),
                                     device=dev)]
    before = ops.launch_counts()
    got = lookup.batched_searchsorted_runs_cuda(keys, offs, nv, q)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {n: after[n] - before[n] for n in after
            if after[n] != before[n]} == {"batched_searchsorted_runs": 1}
    want = lookup.batched_searchsorted_runs_ref(keys, offs, nv, q)
    assert got.dtype == torch.int32 and got.shape == (k, b)
    assert torch.equal(got, want)
    assert bool((got <= nv[:, None]).all())


# (filter keys of each run, indices of filterless runs, B).  Filters of
# FILTER_MIN_BITS (12 keys), segment-sized ones, and ones over the kernel's
# shared-memory stage (9,000 and 20,000 keys: 8,192 and 16,384 words);
# R = 1100 and 300 are not multiples of the kernel's run columns (1,056
# at B = 1 and 212 at B = 16,385 on 132 SMs).
PRESENCE_CASES = {
    "r1_b1": ([700], (), 1),
    "r1_big_b16385": ([20_000], (), 16_385),
    "mixed_b33": ([1, 12, 9_000, 700, 40, 4_000], (1, 3), 33),
    "r1100_b1": ([12, 300] * 550, (5,), 1),
    "r300_b16385": ([4_000, 12, 9_000] + [2_000] * 297, (3, 7), 16_385),
    "r2048_b16384": ([9_000] + [2_000] * 2047, (3,), 16_384),
}


def _presence_case(rng, sizes, filterless, b, dev):
    keysets = [np.unique(rng.integers(0, 1 << 22, n)) for n in sizes]
    filts = [None if i in filterless else filters.from_vkeys(k)
             for i, k in enumerate(keysets)]
    words, offs, masks = _stack_presence(
        [(SimpleNamespace(presence=f), 0) for f in filts], dev)
    pool = np.concatenate(keysets[:8])
    q = np.concatenate([rng.choice(pool, b // 2), rng.integers(
        -(1 << 31), 1 << 31, b - b // 2)]).astype(np.int32)
    q[:2] = (INVALID_VID, -(1 << 31))[:b]
    return words, offs, masks, torch.from_numpy(q).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PRESENCE_CASES))
def test_cuda_presence_matches_plain_version(case):
    """presence_matrix_cuda byte-equal to its plain version: filterless
    rows, rows on both sides of the shared-memory stage, R = 1 and R not a
    multiple of the run columns, B = 1, 33, 16,385 (rows not 16-byte
    aligned) and 16,384; one counted launch a call."""
    dev = _card()
    sizes, filterless, b = PRESENCE_CASES[case]
    rng = np.random.default_rng(len(sizes) * 7 + b)
    args = _presence_case(rng, sizes, filterless, b, dev)
    over_stage = int(args[2].max()) // 32 + 1 > presence.stage_words()
    assert over_stage == (max(sizes) > 8_192)
    before = ops.launch_counts()["presence_matrix"]
    got = presence.presence_matrix_cuda(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts()["presence_matrix"] == before + 1
    want = presence.presence_matrix_ref(*args)
    assert got.dtype == torch.bool and got.shape == (len(sizes), b)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_presence_repeat_byte_equal():
    """20 calls of presence_matrix_cuda on the same inputs give the same
    bytes, equal to the plain version's."""
    dev = _card()
    rng = np.random.default_rng(20)
    args = _presence_case(rng, *PRESENCE_CASES["r300_b16385"], dev)
    want = presence.presence_matrix_ref(*args)
    for _ in range(20):
        assert torch.equal(presence.presence_matrix_cuda(*args), want)


def _attention_case(rng, b, hq, hkv, sq, skv, d, dtype, dev):
    def t(h, s):
        x = rng.normal(size=(b, h, s, d)).astype(np.float32)
        return torch.from_numpy(x).to(dev, dtype)
    return t(hq, sq), t(hkv, skv), t(hkv, skv)


ATT_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, dtype, causal)
    (1, 4, 4, 128, 128, 32, torch.float32, True),       # GQA group 1
    (2, 8, 2, 256, 256, 64, torch.bfloat16, True),      # group 4
    (1, 7, 1, 128, 384, 128, torch.float16, True),      # group 7, Sq < Skv
    (1, 4, 2, 384, 128, 64, torch.float32, True),       # Sq > Skv
    (1, 4, 1, 256, 128, 128, torch.bfloat16, True),     # Sq > Skv
    (1, 2, 1, 256, 128, 32, torch.float16, True),       # Sq > Skv
    (1, 2, 2, 128, 256, 256, torch.float32, True),      # D 256
    (1, 4, 2, 256, 256, 256, torch.bfloat16, False),    # non-causal
    (2, 4, 4, 128, 256, 128, torch.float32, False),
    (1, 2, 2, 256, 256, 32, torch.float16, False),
    (1, 8, 2, 512, 128 * 4, 128, torch.float32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATT_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_cuda_flash_attention_matches_plain_version(case):
    b, hq, hkv, sq, skv, d, dtype, causal = case
    dev = _card()
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = _attention_case(rng, b, hq, hkv, sq, skv, d, dtype, dev)
    before = ops.launch_counts()["flash_attention"]
    got = flash.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash.mha_ref(q.float(), k.float(), v.float(), causal=causal)
    tol = (dict(rtol=1e-3, atol=2e-3) if dtype == torch.float32
           else dict(rtol=0.0, atol=2e-2))
    torch.testing.assert_close(got.float(), want, **tol)
    via_ops = ops.attention(q, k, v, causal=causal, use_pallas=True)
    assert torch.equal(via_ops, got)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_unsupported_shapes():
    dev = _card()
    rng = np.random.default_rng(3)
    q, k, v = _attention_case(rng, 1, 2, 2, 128, 128, 48, torch.float32, dev)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_attention_cuda(q, k, v)
    q, k, v = _attention_case(rng, 1, 3, 2, 128, 128, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash.flash_attention_cuda(q, k, v)
    q, k, v = _attention_case(rng, 1, 2, 2, 192, 128, 64, torch.float32, dev)
    with pytest.raises(ValueError, match="multiples of 128"):
        flash.flash_attention_cuda(q, k, v)


def _runs(rng, sizes, n_out, n_x, dev, *, real_x=False):
    """Runs laid end to end, each sorted by source id: ids recurring in
    every run, a run ending and the next beginning with the same id, empty
    runs, -1 tombstones, zero weights, ids >= n_out and dst out of range."""
    segs = [np.sort(rng.integers(0, n_out + 5, n)).astype(np.int32)
            for n in sizes]
    for a, b in zip(segs, segs[1:]):
        if len(a) and len(b):
            b[: max(len(b) // 8, 1)] = a[-1]
            b.sort()
    seg = np.concatenate(segs)
    dst = rng.integers(-3, n_x + 3, seg.shape[0]).astype(np.int32)
    wt = rng.choice([1.0, -1.0, 0.0, 1.0], seg.shape[0]).astype(np.float32)
    x = (rng.normal(size=n_x) if real_x
         else rng.integers(-2, 3, n_x)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (dst, seg, wt, x)]


@pytest.mark.cuda
def test_cuda_segsum_runs_matches_plain_version():
    """The multi-run segment sum against its plain version: 1,936 runs of
    the multi-level shape's kind (small id ranges, recurring ids), single
    records, empty runs and one run of 2,000,000 records; exact on integer
    inputs (every float32 partial is an integer below 2**24), SEG_TOL on
    real x; one launch a call."""
    dev = _card()
    rng = np.random.default_rng(9)
    ops.reset_launches()
    cases = [([0], 10, 10), ([5, 0, 1, 0, 7], 6, 4), ([33] * 40, 50, 50),
             (list(rng.integers(0, 3000, 1936)), 100_000, 100_000),
             ([2_000_000, 0, 300_000], 4096, 5000)]
    n_calls = 0
    for sizes, n_out, n_x in cases:
        for real_x in (False, True):
            args = _runs(rng, sizes, n_out, n_x, dev, real_x=real_x)
            want = segred.gather_segsum_runs_ref(*args, n_out)
            for got in (segred.gather_segsum_runs_cuda(*args, n_out),
                        ops.gather_segsum_runs(*args, n_out=n_out)):
                n_calls += 1
                if real_x:
                    torch.testing.assert_close(got, want, **SEG_TOL)
                else:
                    assert torch.equal(got + 0.0, want + 0.0), sizes[:5]
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_segsum_runs"] == n_calls
    assert ops.launch_counts()["gather_segsum"] == 0


def _limit_share(got, want):
    """Largest ratio of |got - want| to 2^-7 |want| + 1e-4."""
    return float(((got - want).abs() / (2.0 ** -7 * want.abs() + 1e-4))
                 .max())


MMA_CASES = [
    # (B, Hq, Hkv, Sq, Skv, D, dtype, causal)
    (1, 4, 2, 512, 512, 128, torch.bfloat16, True),     # GQA 4/2
    (1, 4, 2, 512, 512, 64, torch.float16, True),
    (2, 4, 4, 256, 640, 64, torch.bfloat16, True),      # Sq < Skv
    (1, 2, 1, 128, 1024, 128, torch.float16, True),     # Sq < Skv
    (1, 4, 2, 512, 256, 128, torch.bfloat16, True),     # Sq > Skv
    (1, 2, 2, 384, 128, 64, torch.float16, True),       # Sq > Skv
    (1, 4, 2, 256, 768, 128, torch.bfloat16, False),    # non-causal
    (1, 6, 3, 128, 512, 64, torch.float16, False),
    (2, 8, 1, 256, 256, 128, torch.float16, False),
    (1, 28, 4, 1024, 1024, 128, torch.bfloat16, True),  # Qwen2-7B heads
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MMA_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_cuda_flash_attention_tensor_cores(case):
    """bfloat16 and float16 at D 64 and 128 take the tensor-core kernel and
    stay within 2^-7 |want| + 1e-4 of the float32 plain version,
    elementwise; rows that see no key (Sq > Skv, causal) give the mean of
    v."""
    b, hq, hkv, sq, skv, d, dtype, causal = case
    dev = _card()
    assert flash.kernel_path(dtype, d) == "tensor_cores"
    rng = np.random.default_rng(sq * 7 + skv + d)
    q, k, v = _attention_case(rng, b, hq, hkv, sq, skv, d, dtype, dev)
    before = dict(flash.flash_attention_cuda.path_launches)
    n0 = ops.launch_counts()["flash_attention"]
    got = flash.flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    after = flash.flash_attention_cuda.path_launches
    assert after["tensor_cores"] == before["tensor_cores"] + 1
    assert after["cuda_cores"] == before["cuda_cores"]
    assert ops.launch_counts()["flash_attention"] == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash.mha_ref(q.float(), k.float(), v.float(), causal=causal)
    share = _limit_share(got.float(), want)
    assert share <= 1.0, share
    torch.testing.assert_close(got.float(), want, rtol=0.0, atol=2e-2)
    if causal and sq > skv:
        blind = sq - skv                      # rows i with i + Skv - Sq < 0
        mean = v.float().mean(dim=2, keepdim=True)
        mean = mean.repeat_interleave(hq // hkv, dim=1)
        share = _limit_share(got[:, :, :blind].float(),
                             mean.expand(-1, -1, blind, -1))
        assert share <= 1.0, share


@pytest.mark.cuda
def test_cuda_flash_attention_path_by_dtype_and_head_dim():
    """float32 at every D, and bfloat16/float16 at D 32 and 256, take the
    CUDA-core kernel; which kernel runs depends on nothing else."""
    dev = _card()
    rng = np.random.default_rng(5)
    for dtype, d, path in ((torch.float32, 64, "cuda_cores"),
                           (torch.float32, 128, "cuda_cores"),
                           (torch.bfloat16, 32, "cuda_cores"),
                           (torch.float16, 256, "cuda_cores"),
                           (torch.bfloat16, 64, "tensor_cores"),
                           (torch.float16, 128, "tensor_cores")):
        assert flash.kernel_path(dtype, d) == path
        q, k, v = _attention_case(rng, 1, 2, 1, 128, 256, d, dtype, dev)
        before = dict(flash.flash_attention_cuda.path_launches)
        got = flash.flash_attention_cuda(q, k, v, causal=True)
        torch.cuda.synchronize()
        after = flash.flash_attention_cuda.path_launches
        assert {p: after[p] - before[p] for p in after} == {
            p: int(p == path) for p in after}, (dtype, d)
        want = flash.mha_ref(q.float(), k.float(), v.float(), causal=True)
        tol = (dict(rtol=1e-3, atol=2e-3) if dtype == torch.float32
               else dict(rtol=0.0, atol=2e-2))
        torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
def test_cuda_flash_attention_tensor_cores_need_aligned_inputs():
    dev = _card()
    rng = np.random.default_rng(6)
    q, k, v = _attention_case(rng, 1, 2, 2, 128, 128, 64, torch.bfloat16,
                              dev)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        flash.flash_attention_cuda(shifted, k, v)


# --------------------------------------------------------------- merges
def _sorted_triples(rng, n, cap, kmax):
    """n (k1, k2, k3)-sorted int32 triples in cap slots (all-MAX pads)."""
    k = [rng.integers(0, kmax, n).astype(np.int32) for _ in range(3)]
    o = np.lexsort((k[2], k[1], k[0]))
    out = []
    for x in k:
        p = np.full(cap, INVALID_VID, np.int32)
        p[:n] = x[o]
        out.append(p)
    return out


MERGE_PERM_CASES = [
    # (na, nb, acap, bcap, kmax)
    (0, 0, 0, 0, 5), (0, 0, 64, 64, 5), (0, 3000, 10, 3000, 5),
    (3000, 0, 3000, 7, 5),
    (2047, 1, 2047, 1, 40), (2048, 2048, 2048, 2048, 40),   # tile edges
    (2049, 2047, 2049, 2050, 40), (4095, 4097, 4096, 4100, 40),
    (6000, 5000, 6000, 5000, 1),                            # all keys equal
    (1 << 19, 1 << 19, 1 << 19, (1 << 19) + 9, 1 << 12),    # 2**20 records
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", MERGE_PERM_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_cuda_merge_perm_matches_plain_version(case):
    """The merge-path permutation kernel against its plain version: empty
    inputs, tiles of 2,048 outputs ending one short of, on and one past
    the split, every key equal (ties to A), and 2**20 records."""
    dev = _card()
    na, nb, acap, bcap, kmax = case
    rng = np.random.default_rng(na + 3 * nb)
    a = [torch.from_numpy(k).to(dev)
         for k in _sorted_triples(rng, na, acap, kmax)]
    b = [torch.from_numpy(k).to(dev)
         for k in _sorted_triples(rng, nb, bcap, kmax)]
    before = ops.launch_counts()
    got = merge.merge_perm_cuda(a, b, na, nb)
    want = merge.merge_perm_plain(a, b, na, nb)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (acap + bcap,)
    assert torch.equal(got, want)
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]
            } == {"merge_perm": 1}


def _merge_streams(rng, k, dev):
    """k ragged streams (some with no record, some of one slot), keys from
    a small range so that equal keys meet across streams, and payload of
    1, 4 and 8 bytes a record besides the spine's rid, marker and prop."""
    streams = []
    for i in range(k):
        cap = int(rng.integers(1, 3000)) if i % 7 else int(
            rng.integers(1, 4))
        n = 0 if i % 5 == 4 else int(rng.integers(0, cap + 1))
        keys = _sorted_triples(rng, n, cap, 3 if i % 2 else 50)
        pay = [rng.integers(-1, 9, cap).astype(np.int32),
               rng.random(cap) < 0.3, rng.random(cap).astype(np.float32),
               rng.integers(0, 256, cap).astype(np.uint8),
               rng.integers(-(1 << 62), 1 << 62, cap).astype(np.int64),
               rng.random(cap)]
        streams.append(tuple(torch.from_numpy(c).to(dev)
                             for c in keys + pay))
    return streams


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 1935])
def test_cuda_merge_pairs_matches_plain_version(k):
    """Every round of the tournament over k laid-out streams, keys and
    payload, byte-equal to the plain version on the same buffers and
    tables; one counted launch a round (its split pass and merge)."""
    dev = _card()
    rng = np.random.default_rng(k)
    cols, caps = merge.lay_out(_merge_streams(rng, k, dev))
    plan = merge.merge_plan(caps)
    assert len(plan.rounds) == (k - 1).bit_length()
    want = merge.merge_pairs_plain(cols, plan)
    before = ops.launch_counts()
    got = merge.merge_pairs_cuda(tuple(c.clone() for c in cols), plan)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert len(got) == len(want) == 9
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i
    launched = {n: after[n] - before[n] for n in after
                if after[n] != before[n]}
    assert launched == ({"merge_pairs": len(plan.rounds)} if k > 1 else {})


@pytest.mark.cuda
def test_cuda_tournament_merge_launches_once_a_round():
    """tournament_merge on the card: ceil(log2 k) round launches of
    merge_pairs and no merge_perm; equal to the CPU tournament."""
    dev = _card()
    rng = np.random.default_rng(33)
    streams = _merge_streams(rng, 33, dev)
    before = ops.launch_counts()
    got = ops.tournament_merge(streams)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["merge_pairs"] - before["merge_pairs"] == 6
    assert after["merge_perm"] == before["merge_perm"]
    want = ops.tournament_merge([tuple(c.cpu() for c in s)
                                 for s in streams])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_cuda_merge_pairs_rejects_what_it_cannot_move():
    dev = _card()
    keys = [torch.zeros(8, dtype=torch.int32, device=dev) for _ in range(3)]
    plan = merge.merge_plan([4, 4])
    with pytest.raises(TypeError, match="2 bytes"):
        merge.merge_pairs_cuda(
            keys + [torch.zeros(8, dtype=torch.int16, device=dev)], plan)
    with pytest.raises(TypeError, match="int32"):
        merge.merge_pairs_cuda([k.long() for k in keys], plan)
    with pytest.raises(ValueError, match="records"):
        merge.merge_pairs_cuda(keys, merge.merge_plan([4, 5]))


@pytest.mark.cuda
def test_cuda_store_spine_matches_cpu_store():
    """One stream through a store on the card and one on the CPU: the
    runs laid end to end and the spine built from them are byte-equal,
    pads included."""
    from repro_torch.core import store as port_store
    dev = _card()
    cfg = dict(vmax=1 << 12, mem_edges=1 << 10, seg_size=4,
               n_segments=1 << 10, hash_slots=1 << 12, ovf_cap=1 << 12,
               batch_cap=256, l0_run_limit=2, seg_target_edges=256,
               level_factor=2, n_levels=5)
    rng = np.random.default_rng(15)
    key = np.unique(rng.integers(0, 1 << 24, 12000))
    src, dst = key >> 12, key & 4095
    prop = rng.random(len(src)).astype(np.float32)
    spines = []
    for d in (dev, "cpu"):
        g = LSMGraph(StoreConfig(**cfg), device=d)
        for lo in range(0, len(src), 256):
            g.insert_edges(src[lo:lo + 256], dst[lo:lo + 256],
                           prop=prop[lo:lo + 256])
        runs = [(rf, -1) for rf in g.levels[0]] + [
            (rf, c) for c, lvl in enumerate(g.levels[1:]) for rf in lvl]
        spines.append(port_store._build_run_spine(runs, g.device))
    card, cpu = spines
    assert len(card.runs) == len(cpu.runs) >= 20
    assert card.total == cpu.total
    for i, (a, b) in enumerate(zip(card.cols, cpu.cols)):
        assert torch.equal(a.cpu(), b), i


# ------------------------------------------------ durable and concurrent
_DURABLE_CFG = dict(vmax=1 << 12, mem_edges=1 << 11, seg_size=4,
                    n_segments=1 << 11, hash_slots=1 << 12, ovf_cap=1 << 12,
                    batch_cap=256, l0_run_limit=2, seg_target_edges=256,
                    level_factor=2, n_levels=5)


def _unique_stream(seed, n):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, 1 << 24, n))
    rng.shuffle(key)
    return (key >> 12), (key & 4095), rng.random(len(key)).astype(np.float32)


def _lww(src, dst, upto, queries):
    """Insert-only oracle: the adjacency of each query from the first
    ``upto`` records."""
    out = {int(q): [] for q in queries}
    for s, d in zip(src[:upto].tolist(), dst[:upto].tolist()):
        if s in out:
            out[s].append(d)
    return {q: np.array(sorted(v), np.int64) for q, v in out.items()}


def _durable_store(tmp_path, dev, seed=21, n=20000):
    from repro_torch.storage import open_store
    g = open_store(str(tmp_path / "db"), StoreConfig(**_DURABLE_CFG),
                   device=dev)
    src, dst, prop = _unique_stream(seed, n)
    for lo in range(0, len(src), 256):
        g.insert_edges(src[lo:lo + 256], dst[lo:lo + 256],
                       prop=prop[lo:lo + 256])
    assert g.levels[0] and g.levels[1] and g.levels[2]
    return g, src, dst


@pytest.mark.cuda
def test_cuda_durable_round_trip_and_cold_reload(tmp_path):
    """A durable store on the card: every run evicted (its device memory
    freed), reloaded cold from its segment file onto the card byte-equal
    to the pre-evict tensors, reads equal before and after, and equal
    after a close and reopen."""
    dev = _card()
    g, src, dst = _durable_store(tmp_path, dev)
    vs = np.arange(0, 1 << 12, 3)
    with g.snapshot() as snap:
        want = snap.neighbors_batch(vs, return_props=True)
    before = {rf.fid: rf.arrays for lvl in g.levels for rf in lvl}
    assert all(a.dst.device == dev for a in before.values())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    assert g.durability.evict_all_segments() == len(before)
    assert all(rf.arrays is None for lvl in g.levels for rf in lvl)
    with g.snapshot() as snap:
        got = snap.neighbors_batch(vs, return_props=True)
    for (a, p), (b, q) in zip(want, got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p, q)
    for fid, a in before.items():
        b = g.runs_by_fid[fid].arrays
        assert b.dst.device == dev
        nv, ne = int(a.nv), int(a.ne)
        # A flush run is built at the edge count's capacity; a load
        # re-quantizes capacities, so valid prefixes and pads are compared.
        assert torch.equal(a.vkeys[:nv], b.vkeys[:nv]), fid
        assert torch.equal(a.voff[:nv + 1], b.voff[:nv + 1]), fid
        for f in ("dst", "ts", "marker", "prop"):
            assert torch.equal(getattr(a, f)[:ne], getattr(b, f)[:ne]), f
        assert bool((b.vkeys[nv:] == INVALID_VID).all())
        if a.vcap == b.vcap and a.ecap == b.ecap:
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), (fid, f)
    del before
    g.durability.evict_all_segments()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) < held
    g.close()
    from repro_torch.storage import open_store
    g2 = open_store(str(tmp_path / "db"), device=dev)
    with g2.snapshot() as snap:
        got = snap.neighbors_batch(vs, return_props=True)
    for (a, p), (b, q) in zip(want, got):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(p, q)
    g2.close()


@pytest.mark.cuda
def test_cuda_prefetch_then_read_on_another_thread(tmp_path):
    """The upload of a prefetched run is ordered before its reader: the
    read starts on another thread straight after ``_prefetch_range`` (the
    loads still in flight on the pool), 20 times, and each time equals
    the resident read, as do the reloaded run tensors."""
    import threading
    dev = _card()
    g, src, dst = _durable_store(tmp_path, dev, seed=22)
    vs = np.arange(0, 1 << 12, 5)
    with g.snapshot() as snap:
        want = snap.neighbors_batch(vs)
    ref = {rf.fid: (rf.arrays.dst.cpu(), rf.arrays.prop.cpu())
           for lvl in g.levels for rf in lvl}
    for i in range(20):
        g.durability.evict_all_segments()
        out, errs = [], []
        with g.snapshot() as snap:
            assert snap._prefetch_range(0, 1 << 12) > 0

            def read():
                try:
                    out.append(snap.neighbors_batch(vs))
                    for fid, (d, p) in ref.items():
                        a = snap.runs_by_fid[fid].ensure_loaded()
                        assert torch.equal(a.dst.cpu(), d), fid
                        assert torch.equal(a.prop.cpu(), p), fid
                except BaseException as e:
                    errs.append(e)
            t = threading.Thread(target=read)
            t.start()
            t.join(timeout=120)
        assert not t.is_alive() and not errs, (i, errs[:1])
        for a, b in zip(want, out[0]):
            np.testing.assert_array_equal(a, b)
    g.close()


@pytest.mark.cuda
def test_cuda_concurrent_store_reads_equal_oracle(tmp_path):
    """``ConcurrentLSMGraph`` over a durable store on the card: a writer
    (the wrapper's thread) and a reader thread; every snapshot's read
    equals the oracle of the records below its τ, and the store reopens
    to the whole stream's oracle."""
    import threading
    from repro_torch.core.concurrent import ConcurrentLSMGraph
    from repro_torch.storage import open_store
    dev = _card()
    g = ConcurrentLSMGraph(store=open_store(
        str(tmp_path / "db"), StoreConfig(**_DURABLE_CFG), device=dev))
    src, dst, prop = _unique_stream(23, 30000)
    queries = np.unique(src[:300])[:64]
    pins, errs = [], []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set() or len(pins) < 3:
                with g.snapshot() as snap:
                    pins.append((snap.tau, snap.neighbors_batch(queries)))
        except BaseException as e:
            errs.append(e)

    t = threading.Thread(target=reader)
    t.start()
    for lo in range(0, len(src), 256):
        g.insert_edges(src[lo:lo + 256], dst[lo:lo + 256],
                       prop=prop[lo:lo + 256])
    g.flush()
    done.set()
    t.join(timeout=300)
    assert not t.is_alive() and not errs, errs[:1]
    assert len(pins) >= 3
    for tau, out in pins:
        want = _lww(src, dst, tau, queries)
        for q, a in zip(queries, out):
            np.testing.assert_array_equal(a, want[int(q)], err_msg=str(tau))
    g.close()
    g2 = open_store(str(tmp_path / "db"), device=dev)
    want = _lww(src, dst, len(src), queries)
    with g2.snapshot() as snap:
        for q, a in zip(queries, snap.neighbors_batch(queries)):
            np.testing.assert_array_equal(a, want[int(q)])
    g2.close()


def _spine_rounds(state):
    """Rounds of a state's spine tournament: one ``merge_pairs`` a halving
    of its sealed runs, and one more when a sealed MemGraph rides it."""
    runs = sum(1 for lvl in state.levels for rf in lvl if rf.nv > 0)
    handoff = state.mem_full is not None and int(state.mem_full.ne) != 0
    return max(runs - 1, 0).bit_length() + int(handoff and runs > 0)


@pytest.mark.cuda
def test_cuda_sharded_store_reads_equal_oracle(tmp_path):
    """Four durable shards on the card behind ``open_sharded_store``: a
    reader thread pins sharded snapshots during a routed ingest, and each
    read equals the oracle at the snapshot's per-shard τs.  After a reopen
    with every run evicted (the read's prefetch kicks each shard's loads
    before the pool resolves it), one read launches ``merge_pairs``
    exactly once a round of every shard's spine, counted across the pool's
    threads, and never ``merge_perm``; then ``reopen_shard`` recovers each
    shard onto the card, and each cold read stays equal."""
    import threading
    from repro_torch.shard import open_sharded_store
    dev = _card()
    root = str(tmp_path / "sh")
    g = open_sharded_store(root, StoreConfig(**_DURABLE_CFG), device=dev,
                           n_shards=4)
    assert all(sh.device == dev for sh in g.shards)
    src, dst, prop = _unique_stream(24, 30000)
    owner = g.part.owner_of(src)
    queries = np.concatenate([np.unique(src[owner == s])[:24]
                              for s in range(4)])
    by_shard = [np.flatnonzero(owner == s) for s in range(4)]
    pins, errs = [], []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set() or len(pins) < 3:
                with g.snapshot() as snap:
                    pins.append((snap.taus, snap.neighbors_batch(queries)))
        except BaseException as e:
            errs.append(e)

    def want_at(taus):
        """Per shard, the adjacency of its queries from the first τ records
        routed to it (an insert-only stream)."""
        out = {}
        for s, tau in enumerate(taus):
            idx = by_shard[s][:tau]
            out.update(_lww(src[idx], dst[idx], len(idx),
                            queries[g.part.owner_of(queries) == s]))
        return out

    t = threading.Thread(target=reader)
    t.start()
    receipt = None
    for lo in range(0, len(src), 256):
        receipt = g.insert_edges(src[lo:lo + 256], dst[lo:lo + 256],
                                 prop[lo:lo + 256])
    g.ack(receipt)
    done.set()
    t.join(timeout=300)
    assert not t.is_alive() and not errs, errs[:1]
    assert len(pins) >= 3
    for taus, out in pins:
        want = want_at(taus)
        for q, a in zip(queries, out):
            np.testing.assert_array_equal(a, want[int(q)], err_msg=str(taus))
    g.close()

    final = want_at([len(ix) for ix in by_shard])
    g = open_sharded_store(root, device=dev)
    for sh in g.shards:
        sh.durability.evict_all_segments()
    rounds = [_spine_rounds(sh._state) for sh in g.shards]
    assert sum(rounds) > 0
    ops.reset_launches()
    with g.snapshot() as snap:
        out, rep = snap.neighbors_batch(queries, with_report=True)
    counts = ops.launch_counts()
    assert rep.ok
    assert counts["presence_matrix"] > 0
    assert (counts["merge_pairs"], counts["merge_perm"]) == (sum(rounds), 0)
    for q, a in zip(queries, out):
        np.testing.assert_array_equal(a, final[int(q)])
    for s in range(4):
        g.reopen_shard(s)
        assert g.shards[s].device == dev
        for sh in g.shards:
            sh.durability.evict_all_segments()
        with g.snapshot() as snap:
            out = snap.neighbors_batch(queries)
        for q, a in zip(queries, out):
            np.testing.assert_array_equal(a, final[int(q)], err_msg=str(s))
    g.close()


def _store_tensors(store):
    """Every tensor of a store's published state: the MemGraph, the index
    and each resident run's arrays."""
    st = store._state
    for tup in (st.mem, st.index):
        yield from (x for x in tup if isinstance(x, torch.Tensor))
    for lvl in st.levels:
        for rf in lvl:
            if rf.arrays is not None:
                yield from (x for x in rf.arrays
                            if isinstance(x, torch.Tensor))


@pytest.mark.cuda
def test_cuda_benchmark_suites_launch_the_kernels(monkeypatch):
    """Fig 16/17 and Fig 12/13 of the port's benchmark harness on the card
    at smoke scale, with the presence-filter suite beside them: the point
    reads of Fig 16 and the analytics of Fig 12 take no batched read, the
    only path that tests filters on the device (as in the reference).  The
    suites must launch ``presence_matrix``, ``merge_pairs``,
    ``gather_segsum`` and ``gather_segmin``, and every store they build
    must hold no tensor off the card."""
    import contextlib
    import io

    from repro_torch.benchmarks import (bench_analytics, bench_filters,
                                        bench_index, common)
    from repro_torch.core import store as store_mod
    dev = _card()
    stores = []
    init = store_mod.LSMGraph.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        stores.append(self)
    monkeypatch.setattr(store_mod.LSMGraph, "__init__", record)
    ops.reset_launches()
    buf = io.StringIO()
    with common.use_scale(common.Scale(smoke=True)), \
            contextlib.redirect_stdout(buf):
        for suite in (bench_index, bench_analytics, bench_filters):
            suite.main(dev)
    counts = ops.launch_counts()
    for name in ("presence_matrix", "merge_pairs", "gather_segsum",
                 "gather_segmin"):
        assert counts[name] > 0, (name, counts)
    rows = buf.getvalue().splitlines()
    assert any(r.startswith("fig16_read_without_index,") for r in rows)
    assert sum(r.startswith("fig12_") for r in rows) == 25
    assert len(stores) >= 5
    for s in stores:
        assert s.device == dev
        tensors = list(_store_tensors(s))
        assert tensors and all(t.device == dev for t in tensors)


def _dist_pagerank_rank(rank, n_ranks, voff, dst, iters):
    """One rank of ``test_cuda_distributed_pagerank_two_ranks``: its shard
    on the card, fp32 exchange staged through the host."""
    from repro_torch.analytics.view import CSRView
    from repro_torch.core.distributed import (make_distributed_pagerank,
                                              partition_csr)
    from repro_torch.launch.mesh import make_shard_mesh
    mesh = make_shard_mesh(n_ranks, device="cuda:0")
    view = CSRView(voff=torch.from_numpy(voff), dst=torch.from_numpy(dst),
                   prop=torch.ones(len(dst)), n_vertices=len(voff) - 1,
                   n_edges=len(dst))
    run = make_distributed_pagerank(mesh, partition_csr(view, n_ranks),
                                    iters=iters)
    ops.reset_launches()
    x = run()
    return (x.cpu().numpy(), ops.launch_counts()["gather_segsum"],
            mesh.staged_bytes)


@pytest.mark.cuda
def test_cuda_distributed_pagerank_two_ranks():
    """Two gloo ranks sharing the card: fp32 distributed PageRank equals
    the single-store PageRank on the card within phase 11's bound (max |d|
    under 1e-5 of the largest rank), on a vertex count that leaves a pad
    vertex, with one ``gather_segsum`` launch a rank an iteration and the
    exchange staged through the host."""
    from repro_torch.analytics.view import CSRView
    from repro_torch.launch.mesh import spawn_ranks
    dev = _card()
    rng = np.random.default_rng(4)
    V, E, iters = 3001, 40000, 10
    src = np.sort(rng.integers(0, V, E)).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    voff = np.searchsorted(src, np.arange(V + 1)).astype(np.int32)
    view = CSRView(voff=torch.from_numpy(voff).to(dev),
                   dst=torch.from_numpy(dst).to(dev),
                   prop=torch.ones(E, device=dev), n_vertices=V, n_edges=E)
    want = analytics.pagerank(view, iters=iters).cpu().numpy()
    ranks = spawn_ranks(_dist_pagerank_rank, 2, voff, dst, iters,
                        timeout=300)
    for x, launches, staged in ranks:
        assert x.shape == (2 * 1501,)
        assert np.abs(x[:V] - want).max() < 1e-5 * want.max()
        assert np.all(x[V:] == 0.0)
        assert launches == iters
        assert staged > 0


def _chip_smoke():
    """``chip_smoke.py`` (at the repo's root) as a module: phase 12's
    checks at reduced width."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b",
                                  "arctic-480b", "jamba-v0.1-52b",
                                  "mamba2-2.7b", "whisper-small",
                                  "internvl2-26b"])
def test_cuda_serving_family_matches_cpu(arch):
    """Phase 12 (c): the reduced config of each family, float32 weights
    and cache, prefill and 4 decode steps on the card within rtol = atol
    = 1e-3 of the same model on the CPU, each step from the CPU's cache
    before it."""
    dev = _card()
    smoke = _chip_smoke()
    assert smoke.check_family_on_card(arch, dev, 0) <= 1.0


@pytest.mark.cuda
def test_cuda_flash_attention_on_model_activations():
    """Phase 12 (d) at reduced width with Qwen2-1.5B's heads (12 over 2,
    head dim 128): layer 0's q, k, v of a 2 x 256 prompt through
    ``ops.attention(use_pallas=True)``, one launch of ``flash_attention``
    on the tensor cores, within phase 6's bf16 bound of the plain version
    and within relative L1 2e-2 of the model's ``full_attention``."""
    import dataclasses
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    dev = _card()
    smoke = _chip_smoke()
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), n_heads=12,
                              n_kv_heads=2, head_dim=128)
    model = Model(cfg, device=dev, seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 256)).astype(np.int32)).to(dev)
    ops.reset_launches()
    res = smoke.flash_on_activations(cfg, model, toks)
    assert res["launches"] == {"flash_attention": 1}
    assert res["kernel_path"] == ["tensor_cores"]
    assert res["limit_share"] <= 1.0 and res["rel_l1_vs_model"] < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b",
                                  "arctic-480b", "jamba-v0.1-52b",
                                  "mamba2-2.7b", "whisper-small",
                                  "internvl2-26b"])
def test_cuda_train_family_matches_cpu(arch):
    """Phase 13 (c): the reduced config of each family, float32 weights,
    loss, gradients and one AdamW update (lr 1e-3, of the CPU's gradients)
    on the card within rtol = atol = 1e-3 of the same model on the CPU."""
    dev = _card()
    smoke = _chip_smoke()
    assert smoke.check_train_family_on_card(arch, dev, 0) <= 1.0


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu():
    """Three ``make_train_step`` steps (2 micro-batches, base lr 1e-2: lr
    0, 1e-4 and 2e-4) of reduced qwen2-1.5b in float32 from
    ``TokenPipeline``, on the card and on the CPU from the same weights:
    the losses within rtol 1e-5; the parameters within phase 13 (c)'s
    rtol = atol = 1e-3, since each device takes Adam's steps from its own
    gradients, and a gradient within float32 noise of zero can move a
    parameter by up to +-lr a step on either."""
    import copy
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    dev = _card()
    cfg = reduced_config("qwen2-1.5b")
    cpu = Model(cfg, dtype=torch.float32, device="cpu", seed=0)
    card = copy.deepcopy(cpu).to(dev)
    runs = {}
    for name, m, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        step = train.make_train_step(cfg, n_micro=2, base_lr=1e-2)
        opt = adamw_init(m)
        pipe = TokenPipeline(vocab=cfg.vocab, seq_len=32, global_batch=4,
                             seed=0)
        losses = []
        for _ in range(3):
            m, opt, loss = step(m, opt, train.to_device(pipe.next_batch(),
                                                        d))
            losses.append(float(loss))
        runs[name] = losses
    np.testing.assert_allclose(runs["card"], runs["cpu"], rtol=1e-5)
    for (n, p), q in zip(cpu.named_parameters(), card.parameters()):
        torch.testing.assert_close(q.cpu(), p.detach(), rtol=1e-3,
                                   atol=1e-3, msg=n)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [((1000,), torch.float32),
                                         ((512, 1536), torch.bfloat16),
                                         ((3, 7), torch.float32)])
def test_cuda_compress_int8_byte_equal(shape, dtype):
    """Phase 13 (e): the int8 values and the scales the card computes are
    the CPU's, bit for bit (its divisions are by float32 tensors, not the
    Python scalars CUDA turns into products by a reciprocal)."""
    from repro_torch.optim import compress_int8, decompress_int8
    dev = _card()
    g = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.02, shape).astype(np.float32)).to(dtype)
    q, s = compress_int8(g.to(dev))
    qc, sc = compress_int8(g)
    assert torch.equal(q.cpu(), qc)
    assert torch.equal(s.cpu().view(torch.int32), sc.view(torch.int32))
    back = decompress_int8(q, s, shape).cpu()
    assert torch.equal(back, decompress_int8(qc, sc, shape))


@pytest.mark.cuda
def test_cuda_checkpoint_model_round_trip(tmp_path):
    """A bfloat16 model on the card and its AdamW state saved and restored
    into a fresh card template: every tensor bit for bit, on the card."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import reduced_config
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init
    dev = _card()
    cfg = reduced_config("jamba-v0.1-52b")
    model = Model(cfg, device=dev, seed=0)
    opt = adamw_init(model)
    opt.v["embed"].uniform_()
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(3, (model, opt))
    cm.wait()
    fresh = Model(cfg, device=dev, seed=1)
    (got, got_opt), _ = cm.restore((fresh, adamw_init(fresh)))
    for (n, p), q in zip(model.named_parameters(), got.parameters()):
        assert q.device.type == "cuda" and q.dtype == p.dtype
        assert torch.equal(p, q), n
    assert torch.equal(got_opt.v["embed"], opt.v["embed"])


def _warm_cublas(dev):
    """A product forward and backward: cuBLAS gives each thread (the
    autograd engine's too) a handle and a workspace from the caching
    allocator on its first product, which no dry run counts."""
    a = torch.ones(256, 256, device=dev, requires_grad=True)
    (a @ a).sum().backward()
    torch.cuda.synchronize(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cuda_dry_run_holds_to_the_card(kind):
    """The one-card dry run (``launch.dryrun.trace_cell`` with no mesh, on
    fake CUDA tensors) of reduced qwen2-1.5b against the same step run on
    the card, as phase 14 runs it: the traced peak within
    ``dryrun.PEAK_TOL`` of ``torch.cuda.max_memory_allocated`` over a step
    with no dispatch mode, above what was allocated before the step's
    inputs were made, once cuBLAS has its workspaces; then FLOPs equal to
    ``FlopCounterMode``'s count over another step."""
    from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import Model, init_cache
    from repro_torch.optim import adamw_init
    dev = _card()
    cfg = reduced_config("qwen2-1.5b")
    shape = ShapeConfig("t", 256, 8, kind)
    n_micro = 2 if kind == "train" else 1
    trace, _ = dryrun.trace_cell("qwen2-1.5b", shape, None, dev,
                                 n_micro=n_micro, cfg_override=cfg)
    _warm_cublas(dev)
    base = torch.cuda.memory_allocated(dev)
    model = Model(cfg, device=dev, seed=0)
    batch = dryrun.input_specs(cfg, shape, dev)
    if kind == "train":
        opt = adamw_init(model)
        step = dryrun.make_train_step(cfg, n_micro=n_micro)

        def run():
            return step(model, opt, batch)
    elif kind == "prefill":
        step = dryrun.make_prefill_step(cfg, shape.seq_len)

        def run():
            return step(model, batch)
    else:
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device=dev)
        step = dryrun.make_serve_step(cfg)

        def run():
            return step(model, cache, batch["token"], shape.seq_len - 1)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    run()
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    assert abs(trace.peak - peak) <= dryrun.PEAK_TOL * peak, (trace.peak,
                                                              peak)
    fc = FlopCounterMode(display=False)
    with _FlopCounterMode(fc):
        run()
    assert trace.flops == fc.get_total_flops()
