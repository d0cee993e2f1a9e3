"""The port's hand-written CUDA kernels on the card, with no JAX import, so
that the file runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors: segment-min byte-equal (a min is exact in any order; -0.0 is
mapped to +0.0 first), segment-sum within rtol 1e-5 / atol 1e-4 (the
tolerance of ``tests/test_kernels.py``: float atomics add in an order that
changes from run to run), or byte-equal where every partial sum is exact.
The analytics test runs one store on the card and one on the CPU from the
same stream.  Every test skips where there is no card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import analytics  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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
                                   "gather_segsum": n_calls // 2 + 1,
                                   "gather_segmin": n_calls // 2 + 1}


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
