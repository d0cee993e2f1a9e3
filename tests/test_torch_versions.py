"""Vertex-grained version control (paper §4.3, Examples 2-3) in the port,
against the JAX package's.

The four cases of the reference's ``tests/test_versions.py``: each scenario
runs once on a JAX ``LSMGraph`` and once on a port ``LSMGraph`` on the CPU,
with the same inputs (numpy seeds).  What each read sees, the live-version
counts of the version chain (``VersionChain.live_versions``) and
``min_live_tau`` must be equal between the packages, and the reference's
own assertions must hold on the port's values.  Tolerance: none.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402


def _graph(pkg, **kw):
    cfg = small_store_cfg(**kw)
    if pkg == "jax":
        return JaxGraph(cfg)
    return LSMGraph(StoreConfig(**dataclasses.asdict(cfg)), device="cpu")


def _nbrs(snap, v):
    return sorted(int(x) for x in snap.neighbors(v))


def _isolation(pkg):
    g = _graph(pkg)
    g.insert_edges([1, 1, 2], [10, 11, 12])
    snap = g.snapshot()
    before = _nbrs(snap, 1)
    # Mutate heavily: flushes + compactions behind the pinned snapshot.
    rng = np.random.default_rng(0)
    g.insert_edges(rng.integers(0, 100, 5000), rng.integers(0, 100, 5000))
    g.insert_edges([1], [99])
    g.delete_edges([1], [10])
    after = _nbrs(snap, 1)
    snap.release()
    snap2 = g.snapshot()
    now = _nbrs(snap2, 1)
    snap2.release()
    return dict(before=before, after=after, now=now,
                sizes=g.level_sizes())


def _pinned_gc(pkg):
    g = _graph(pkg, l0_run_limit=2)
    g.insert_edges([5], [50])
    snap = g.snapshot()              # pins tau before the delete
    g.delete_edges([5], [50])
    # Deep compaction churn (vertices >= 100 so v5 stays untouched).
    rng = np.random.default_rng(1)
    g.insert_edges(rng.integers(100, 300, 6000),
                   rng.integers(100, 300, 6000))
    g.flush_memgraph()
    pinned = _nbrs(snap, 5)
    snap.release()
    snap2 = g.snapshot()
    fresh = _nbrs(snap2, 5)
    snap2.release()
    return dict(pinned=pinned, fresh=fresh, sizes=g.level_sizes())


def _chain_gc(pkg):
    g = _graph(pkg)
    g.insert_edges([1], [2])
    s1 = g.snapshot()
    s2 = g.snapshot()
    g.insert_edges(np.arange(100), np.arange(100))
    g.flush_memgraph()               # publishes new versions
    live_before = len(g.versions.live_versions())
    s1.release()
    s2.release()
    live_after = len(g.versions.live_versions())
    return dict(live_before=live_before, live_after=live_after,
                min_live_tau=g.versions.min_live_tau(g.tau), tau=g.tau)


def _example3(pkg):
    g = _graph(pkg, l0_run_limit=2, mem_edges=64, batch_cap=32)
    for i in range(6):
        g.insert_edges(np.full(40, i), np.arange(40) + 1000 * i)
    snap_old = g.snapshot()
    pre = {v: _nbrs(snap_old, v) for v in range(6)}
    g.compact_l0()
    post = {v: _nbrs(snap_old, v) for v in range(6)}
    snap_old.release()
    return dict(pre=pre, post=post, sizes=g.level_sizes())


def _both(scenario):
    want, got = scenario("jax"), scenario("torch")
    assert got == want
    return got


def test_snapshot_isolation_across_flush_and_compaction():
    got = _both(_isolation)
    assert got["before"] == got["after"] == [10, 11]
    assert 99 in got["now"] and 10 not in got["now"]


def test_pinned_reader_blocks_gc():
    """Compaction must not GC versions a pinned reader can still see."""
    got = _both(_pinned_gc)
    assert got["pinned"] == [50]
    assert got["fresh"] == []


def test_version_chain_gc():
    got = _both(_chain_gc)
    assert got["live_after"] <= got["live_before"]
    assert got["min_live_tau"] == got["tau"]  # no pinned readers


def test_example3_mid_compaction_visibility():
    """Paper Example 3: a snapshot pinned across ``compact_l0`` reads one
    of the two consistent states, never a torn mix."""
    got = _both(_example3)
    assert got["pre"] == got["post"]
