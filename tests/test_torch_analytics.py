"""The port's analytics held against the JAX package's, on the same stores.

One stream (the ``tests/test_analytics.py`` graph: V = 300, undirected,
weighted, alternating deletes, every edge inserted once) goes through
``repro.core.LSMGraph`` and ``repro_torch.core.LSMGraph(device="cpu")``.
Then both packages materialize the snapshot and run PageRank, BFS, SSSP, CC,
SCAN and merge-free multi-level PageRank; the JAX side runs its Pallas
kernels in interpret mode, as its own tests do.

Tolerances: none for the materialized CSR, the multi-level views, BFS, SSSP,
CC and the SCAN degrees (integers, arrays carried through, and mins of one
float32 add per edge, which are exact in any order).  PageRank, the SCAN
weight sums and multi-level PageRank sum float32 values in another order in
each package: rtol 1e-5 with an atol of 1e-7 (PageRank, values near
1/V = 3.3e-3) or 1e-4 (weight sums, values up to about 30).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import analytics as jan  # noqa: E402
from repro.analytics import view as jview  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro.data.graphgen import powerlaw_edges  # noqa: E402
from repro_torch import analytics as pan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analytics import view as pview  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402

V = 300
PR_TOL = dict(rtol=1e-5, atol=1e-7)
WSUM_TOL = dict(rtol=1e-5, atol=1e-4)


def _pair(**kw):
    jcfg = small_store_cfg(**kw)
    return (JaxGraph(jcfg),
            LSMGraph(StoreConfig(**dataclasses.asdict(jcfg)), device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(3)
    u, w = powerlaw_edges(V, 2500, seed=3)
    keep = u < w      # canonical undirected pairs: each edge inserted once
    u, w = u[keep], w[keep]
    _, first = np.unique(u.astype(np.int64) * V + w, return_index=True)
    u, w = u[np.sort(first)], w[np.sort(first)]
    wt = rng.uniform(0.1, 1.0, len(u)).astype(np.float32)
    k = 300           # deletes: each a single tombstone after its insert
    stores = _pair(vmax=V)
    half = len(u) // 2
    for g in stores:
        # Two L0 runs of inserts and the deletes in the MemGraph: the
        # tombstones annihilate across runs in the multi-level views.
        for part in (slice(0, half), slice(half, None)):
            a, b, c = u[part], w[part], wt[part]
            g.insert_edges(np.r_[a, b], np.r_[b, a], prop=np.r_[c, c])
            g.flush_memgraph()
        g.delete_edges(np.r_[u[:k], w[:k]], np.r_[w[:k], u[:k]])
    live = {}
    for a, b, c in zip(u.tolist(), w.tolist(), wt.tolist()):
        live[(a, b)] = live[(b, a)] = c
    for a, b in zip(u[:k].tolist(), w[:k].tolist()):
        live.pop((a, b))
        live.pop((b, a))
    snaps = [g.snapshot() for g in stores]
    views = (jan.materialize_csr(snaps[0], V),
             pan.materialize_csr(snaps[1], V))
    yield stores, snaps, views, live
    for s in snaps:
        s.release()


def test_materialize_csr_byte_equal(graphs):
    stores, _, (jv, pv), live = graphs
    assert pv.n_vertices == jv.n_vertices == V
    assert pv.n_edges == jv.n_edges == len(live)
    for f in ("voff", "dst", "prop"):
        want = np.asarray(getattr(jv, f))
        got = _np(getattr(pv, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    np.testing.assert_array_equal(_np(pv.seg_ids()), np.asarray(jv.seg_ids()))
    np.testing.assert_array_equal(_np(pv.degrees), np.asarray(jv.degrees))
    assert stores[0].io.analytics_read == stores[1].io.analytics_read
    back = convert.csr_view_to_torch(jv, "cpu")
    for f in ("voff", "dst", "prop"):
        assert torch.equal(getattr(back, f), getattr(pv, f))


def test_pagerank_matches_jax(graphs):
    _, _, (jv, pv), _ = graphs
    got = _np(pan.pagerank(pv, iters=10))
    want = np.asarray(jan.pagerank(jv, iters=10))
    assert got.dtype == np.float32 and got.shape == (V,)
    np.testing.assert_allclose(got, want, **PR_TOL)
    assert abs(got.sum() - 1.0) < 1e-3
    plain = _np(pan.pagerank(pv, iters=10, use_pallas=False))
    np.testing.assert_allclose(plain, got, **PR_TOL)


def test_min_algorithms_match_jax_exactly(graphs):
    _, _, (jv, pv), live = graphs
    src = min(a for a, _ in live)
    for name, args in (("bfs", (src,)), ("sssp", (src,)), ("cc", ())):
        got = _np(getattr(pan, name)(pv, *args))
        want = np.asarray(getattr(jan, name)(jv, *args))
        assert got.dtype == want.dtype and got.shape == (V,), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # The port's algorithms on the JAX view, carried over field by field.
    jv_t = convert.csr_view_to_torch(jv, "cpu")
    np.testing.assert_array_equal(_np(pan.cc(jv_t)), np.asarray(jan.cc(jv)))


def test_scan_stats_match_jax(graphs):
    _, _, (jv, pv), live = graphs
    deg, wsum = (_np(a) for a in pan.scan_stats(pv))
    jdeg, jwsum = (np.asarray(a) for a in jan.scan_stats(jv))
    np.testing.assert_array_equal(deg, jdeg)
    np.testing.assert_allclose(wsum, jwsum, **WSUM_TOL)
    assert int(deg.sum()) == len(live)


def test_multilevel_views_and_pagerank_match_jax(graphs):
    _, snaps, (_, pv), _ = graphs
    jviews = jan.multilevel_views(snaps[0])
    pviews = pan.multilevel_views(snaps[1])
    assert len(pviews) == len(jviews) >= 3
    for jrv, prv in zip(jviews, pviews):
        crv = convert.run_view_to_torch(jrv, "cpu")
        for f in prv._fields:
            assert torch.equal(getattr(prv, f), getattr(crv, f)), f
    got = _np(pan.multilevel_pagerank(pviews, n_out=V, iters=10))
    want = np.asarray(jan.multilevel_pagerank(jviews, n_out=V, iters=10))
    np.testing.assert_allclose(got, want, **PR_TOL)
    merged = _np(pan.pagerank(pv, iters=10))
    np.testing.assert_allclose(got, merged, **PR_TOL)
    deg = _np(pan.multilevel_degree(pviews, n_out=V))
    np.testing.assert_array_equal(deg, _np(pv.degrees).astype(np.float32))


@pytest.mark.parametrize("k,branch", [(3, "kernel_merge"),
                                      (9, "host_lexsort")])
def test_collect_sorted_branch_counts(k, branch):
    """k L0 runs: 2..8 sources merge in the tournament, more are sorted as
    one concatenation; both packages count the branch under its key and
    give byte-equal CSRs."""
    rng = np.random.default_rng(7)
    stores = _pair(l0_run_limit=k + 64)
    for _ in range(k):
        s, d = rng.integers(0, 400, 400), rng.integers(0, 400, 400)
        key = np.unique(s * 400 + d)      # distinct within a run
        s, d = key // 400, key % 400
        keep = rng.random(len(s)) < 0.5
        for g in stores:
            g.insert_edges(s[keep], d[keep])
            g.flush_memgraph()
    pstats, jstats = pview.MERGE_STATS, jview.MERGE_STATS
    before = (pstats.snapshot_stats(), dict(jstats))
    with stores[0].snapshot() as js, stores[1].snapshot() as ps:
        jv, pv = jan.materialize_csr(js, 400), pan.materialize_csr(ps, 400)
    after = (pstats.snapshot_stats(), dict(jstats))
    dp, dj = ({key: a[key] - b[key] for key in ("kernel_merge",
                                                "host_lexsort")}
              for a, b in zip(after, before))
    assert dj[branch] == 1 and dp["host_lexsort"] == dj["host_lexsort"]
    if branch == "kernel_merge":
        # The port's merge_streams also counts each of its k - 1 pairwise
        # merges under this key.
        assert dp["kernel_merge"] == 1 + (k - 1)
    else:
        assert dp["kernel_merge"] == dj["kernel_merge"] == 0
    for f in ("voff", "dst", "prop"):
        np.testing.assert_array_equal(_np(getattr(pv, f)),
                                      np.asarray(getattr(jv, f)), f)
