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
from repro import storage as jstorage  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core.types import BYTES_PER_EDGE, BYTES_PER_PROP  # noqa: E402
from repro_torch.kernels.merge import MERGE_STATS, merge_plan  # noqa: E402
from repro_torch.storage import open_store  # noqa: E402
from repro_torch.storage.errors import DegradedRange  # noqa: E402

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
    """k L0 runs: the reference merges 2..8 sources in its tournament and
    sorts more as one concatenation, counting the branch under its key;
    the port lays every source end to end and merges them in one
    tournament at any k, counting its pairwise merges under
    ``kernel_merge`` and no host sort.  Both give byte-equal CSRs."""
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
    pstats, jstats = MERGE_STATS, jview.MERGE_STATS
    before = (pstats.snapshot_stats(), dict(jstats))
    with stores[0].snapshot() as js, stores[1].snapshot() as ps:
        caps = pview._laid_out_sources(ps)[1]
        jv, pv = jan.materialize_csr(js, 400), pan.materialize_csr(ps, 400)
    after = (pstats.snapshot_stats(), dict(jstats))
    dp, dj = ({key: a[key] - b[key] for key in ("kernel_merge",
                                                "host_lexsort")}
              for a, b in zip(after, before))
    assert dj[branch] == 1 and dj["kernel_merge"] + dj["host_lexsort"] == 1
    # The active MemGraph tier (empty here) and the k runs.
    assert len(caps) == 1 + k
    assert dp == {"kernel_merge": merge_plan(caps).merges,
                  "host_lexsort": 0}
    for f in ("voff", "dst", "prop"):
        np.testing.assert_array_equal(_np(getattr(pv, f)),
                                      np.asarray(getattr(jv, f)), f)


# --------------------------------------- materialize_csr's sources, by case
def _edges(seed, n, v=400):
    """n distinct (src, dst) pairs below v in random order, with props."""
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, v * v, n))
    rng.shuffle(key)
    return key // v, key % v, rng.random(len(key)).astype(np.float32)


def _runs(g, parts, seed):
    """Each part of one stream of distinct pairs inserted and flushed into
    an L0 run; every fourth pair of each part then deleted in the next."""
    s, d, p = _edges(seed, 300 * parts)
    for i in range(parts):
        sl = slice(i * len(s) // parts, (i + 1) * len(s) // parts)
        g.insert_edges(s[sl], d[sl], prop=p[sl])
        if i:
            prev = slice((i - 1) * len(s) // parts, i * len(s) // parts)
            g.delete_edges(s[prev][::4], d[prev][::4])
        g.flush_memgraph()
    return s, d, p


def _snapshot_of(g, state):
    """A snapshot object of ``state``, of ``g``'s package (not pinned)."""
    with g.snapshot() as snap:
        cls = type(snap)
    return cls(g, state)


def _case_memgraph_only(g, _tmp):
    s, d, p = _edges(11, 400)
    g.insert_edges(s, d, prop=p)
    g.delete_edges(s[::5], d[::5])
    assert not any(g.levels)
    return g.snapshot()


def _case_one_run(g, _tmp):
    s, d, p = _edges(12, 500)
    g.insert_edges(s, d, prop=p)
    g.delete_edges(s[::7], d[::7])
    g.flush_memgraph()
    assert len(g.levels[0]) == 1 and int(g.mem.ne) == 0
    return g.snapshot()


def _case_deep_sealed_tier(g, _tmp):
    """L1 runs from a compaction, L0 runs after it, and the state between
    a flush's rotate and its commit: the full MemGraph sealed (mem_full)
    while a fresh one holds newer writes."""
    _runs(g, 4, seed=13)
    g.compact_l0()
    _runs(g, 5, seed=14)
    s, d, p = _edges(15, 600)
    g.insert_edges(s[:300], d[:300], prop=p[:300])
    g.delete_edges(s[:300:6], d[:300:6])
    before = g._state
    g.flush_memgraph()
    g.insert_edges(s[300:], d[300:], prop=p[300:])
    g.delete_edges(s[:300:9], d[:300:9])
    after = g._state
    assert len(before.levels[0]) + len(before.levels[1]) >= 9
    st = dataclasses.replace(
        after, mem_full=before.mem, mem_full_id=before.mem_id,
        levels=before.levels, index=before.index,
        runs_by_fid=before.runs_by_fid, spine=type(after.spine)())
    snap = _snapshot_of(g, st)
    assert len(snap.mem_states) == 2
    return snap


def _case_tombstones_across_levels(g, _tmp):
    """Keys inserted in L1, deleted in L0, inserted again in the MemGraph;
    and the other way round."""
    s, d, p = _edges(16, 600)
    a, b = slice(0, 300), slice(300, 600)
    g.insert_edges(s[a], d[a], prop=p[a])
    g.flush_memgraph()
    g.compact_l0()
    g.delete_edges(s[a][::2], d[a][::2])
    g.insert_edges(s[b], d[b], prop=p[b])
    g.flush_memgraph()
    g.insert_edges(s[a][::4], d[a][::4], prop=p[a][::4] + 1)
    g.delete_edges(s[b][::3], d[b][::3])
    assert g.levels[0] and g.levels[1]
    return g.snapshot()


def _case_records_past_tau(g, _tmp):
    """A state that holds records written after its τ: runs flushed and
    MemGraph records past it are filtered out."""
    _runs(g, 2, seed=17)
    tau = g._state.tau
    _runs(g, 2, seed=18)
    s, d, p = _edges(19, 200)
    g.insert_edges(s, d, prop=p)
    return _snapshot_of(g, dataclasses.replace(g._state, tau=tau))


def _case_degraded_run(g, _tmp):
    _runs(g, 3, seed=20)
    rf = g.levels[0][1]
    bad = (DegradedRange(rf.min_vid, rf.max_vid, rf.fid, "test"),)
    g.degraded_ranges = lambda: bad
    snap = g.snapshot()
    assert rf.fid not in {r.fid for r in snap.l0_runs}
    return snap


def _case_durable_cold(g, _tmp):
    _runs(g, 3, seed=21)
    g.compact_l0()
    _runs(g, 2, seed=22)
    assert g.durability.evict_all_segments() == len(g.runs_by_fid) >= 3
    snap = g.snapshot()
    assert all(rf.arrays is None for rf in snap.runs_by_fid.values())
    return snap


CASES = {"memgraph_only": _case_memgraph_only,
         "one_run": _case_one_run,
         "deep_sealed_tier": _case_deep_sealed_tier,
         "tombstones_across_levels": _case_tombstones_across_levels,
         "records_past_tau": _case_records_past_tau,
         "degraded_run": _case_degraded_run,
         "durable_cold": _case_durable_cold}


def _case_pair(case, tmp_path):
    jcfg = small_store_cfg(l0_run_limit=64, seg_target_edges=256)
    pcfg = StoreConfig(**dataclasses.asdict(jcfg))
    if case == "durable_cold":
        stores = (jstorage.open_store(str(tmp_path / "j"), jcfg,
                                      wal_sync="off"),
                  open_store(str(tmp_path / "p"), pcfg, device="cpu",
                             wal_sync="off"))
    else:
        stores = (JaxGraph(jcfg), LSMGraph(pcfg, device="cpu"))
    return stores, [CASES[case](g, tmp_path) for g in stores]


@pytest.mark.parametrize("case", list(CASES))
def test_materialize_csr_matches_reference_by_case(case, tmp_path):
    """The port's view of each kind of snapshot byte-equal to the
    reference's: offsets, neighbours, properties and the bytes charged;
    every source merged once."""
    stores, snaps = _case_pair(case, tmp_path)
    ps = snaps[1]
    want_sources = len(ps.mem_states) + sum(
        rf.nv > 0 for rf in ps.runs_by_fid.values())
    read0 = [g.io.analytics_read for g in stores]
    sources = obs.REGISTRY.counter("analytics_view_sources_total",
                                   store=stores[1].obs_label)
    n0 = sources.value
    jv, pv = jan.materialize_csr(snaps[0], 400), pan.materialize_csr(ps, 400)
    assert sources.value - n0 == want_sources
    assert pv.n_edges == jv.n_edges > 0
    for f in ("voff", "dst", "prop"):
        want, got = np.asarray(getattr(jv, f)), _np(getattr(pv, f))
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert [g.io.analytics_read - r for g, r in zip(stores, read0)] == \
        [jv.n_edges * (BYTES_PER_EDGE + BYTES_PER_PROP)] * 2
    for g in stores:
        g.close()


def test_view_sources_counter_counts_each_source():
    """``analytics_view_sources_total`` advances by the sources a build
    merges: the MemGraph tiers and every sealed run with a vertex, one
    pairwise merge fewer than sources."""
    g = LSMGraph(StoreConfig(**dataclasses.asdict(
        small_store_cfg(l0_run_limit=64, seg_target_edges=256))),
        device="cpu")
    snap = _case_deep_sealed_tier(g, None)
    runs = [rf for lvl in [snap.l0_runs] + snap.level_runs for rf in lvl]
    n_sources = 2 + len(runs)
    assert len(runs) >= 9 and all(rf.nv > 0 for rf in runs)
    sources = obs.REGISTRY.counter("analytics_view_sources_total",
                                   store=g.obs_label)
    merges = obs.REGISTRY.counter("merge_kernel_merge_total")
    n0, m0 = sources.value, merges.value
    for i in range(2):
        pan.materialize_csr(snap, 400)
        assert sources.value - n0 == (i + 1) * n_sources
        assert merges.value - m0 == (i + 1) * (n_sources - 1)


def test_one_layout_lays_tiers_then_runs():
    """``store.lay_out_runs`` with a deep store's two MemGraph tiers
    leading its runs: each source's slice of every column is its tier's
    stream, or its run's records (``csr.expand_src`` of the run, then its
    columns, with the run's position as rid), pads included; ``caps`` holds
    each source's capacity.  The view's sources are the same columns
    without the rid."""
    from repro_torch.core import csr as pcsr
    from repro_torch.core import memgraph as pmg
    from repro_torch.core import store as port_store
    g = LSMGraph(StoreConfig(**dataclasses.asdict(
        small_store_cfg(l0_run_limit=64, seg_target_edges=256))),
        device="cpu")
    snap = _case_deep_sealed_tier(g, None)
    runs = [rf for lvl in [snap.l0_runs] + snap.level_runs for rf in lvl]
    tiers = [pmg.backbone_stream(mg) for mg in snap.mem_states]
    assert len(tiers) == 2 and len(runs) >= 9
    cols, caps = port_store.lay_out_runs(runs, leads=tiers)
    want = tiers + [
        (pcsr.expand_src(a), a.dst, a.ts,
         torch.full(a.dst.shape, i, dtype=torch.int32), a.marker, a.prop)
        for i, a in enumerate(rf.ensure_loaded() for rf in runs)]
    assert caps == [int(w[0].shape[0]) for w in want]
    starts = np.cumsum([0] + caps)
    for k, (w, lo, hi) in enumerate(zip(want, starts[:-1], starts[1:])):
        for i, (c, x) in enumerate(zip(cols, w)):
            assert c.dtype == x.dtype and torch.equal(c[lo:hi], x), (k, i)
    assert all(int(c.shape[0]) == starts[-1] for c in cols)
    got, got_caps = pview._laid_out_sources(snap)
    assert got_caps == caps
    for i, (a, b) in enumerate(zip(got, cols[:3] + cols[4:])):
        assert a.dtype == b.dtype and torch.equal(a, b), i
