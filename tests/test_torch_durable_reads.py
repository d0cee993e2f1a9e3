"""The port's read path over evicted (cold) runs of a durable store.

Ports of the durable cases of the reference's ``tests/test_read_pipeline.py``:
whatever the read path overlaps (background segment loads, chunked
resolves, a concurrent compaction that unlinks replaced files),
``neighbors_batch`` stays equal to the per-vertex ``neighbors_scalar``.
Beyond them, the same stream through a durable store of each package must
read byte-equal cold, on the spine and on the legacy path.  Every wait on a
background thread is bounded.  Tolerance: none (integers and float32
properties carried through unchanged).
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import storage as jstorage  # noqa: E402
from repro.core import store as jax_store  # noqa: E402
from repro_torch.core import StoreConfig  # noqa: E402
from repro_torch.core import store as port_store  # noqa: E402
from repro_torch.core.store import prefetch_pool  # noqa: E402
from repro_torch.storage import open_store  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while each test runs (restored after): the
    tensors here are small, and the suite runs several workers on one
    machine, where every worker's spinning OpenMP threads would
    oversubscribe the cores and slow the tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_batch_equals_scalar(snap, vs):
    batch = snap.neighbors_batch(vs)
    assert len(batch) == len(vs)
    for v, got in zip(vs, batch):
        ref = snap.neighbors_scalar(int(v))
        np.testing.assert_array_equal(got, ref, err_msg=f"vertex {v}")
        assert got.dtype == ref.dtype


def _fill(g, n_runs, seed, v=500, per_run=900):
    rng = np.random.default_rng(seed)
    for i in range(n_runs):
        src = rng.integers(0, v, per_run).astype(np.int32)
        dst = rng.integers(0, v, per_run).astype(np.int32)
        g.insert_edges(src, dst, prop=rng.random(per_run).astype(np.float32))
        if i == n_runs // 2:
            di = rng.choice(per_run, per_run // 8, replace=False)
            g.delete_edges(src[di], dst[di])
        g.flush_memgraph()
    assert len(g.levels[0]) == n_runs and int(g.mem.ne) == 0
    return g


def _durable_multi_run_store(root, n_runs=4, seed=0):
    """A durable store with ``n_runs`` evictable L0 runs + tombstones."""
    cfg = small_store_cfg(l0_run_limit=n_runs + 64)
    g = open_store(str(root), StoreConfig(**dataclasses.asdict(cfg)),
                   device="cpu", wal_sync="off")
    return _fill(g, n_runs, seed)


def _evict_all(g) -> int:
    return sum(bool(rf.evict()) for lvl in g.levels for rf in lvl)


def _wait_for(cond, what, limit=30.0):
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


# ------------------------------------------------------------------ prefetch
def test_cold_evicted_batch_equals_scalar(tmp_path):
    """Every segment evicted: the batched resolve reloads them through the
    background prefetcher and still matches the scalar oracle."""
    g = _durable_multi_run_store(tmp_path, n_runs=4)
    try:
        snap = g.snapshot()
        assert _evict_all(g) == 4
        _assert_batch_equals_scalar(snap, np.arange(0, 520))
        snap.release()
        assert g.io.cold_load > 0
    finally:
        g.close()


def test_prefetch_range_loads_in_background(tmp_path):
    """_prefetch_range alone (no foreground read) re-materializes cold
    overlapping runs via the shared pool."""
    g = _durable_multi_run_store(tmp_path, n_runs=3)
    try:
        snap = g.snapshot()
        assert _evict_all(g) == 3
        assert snap._prefetch_range(0, g.cfg.vmax) == 3
        runs = list(g.levels[0])
        _wait_for(lambda: all(rf.arrays is not None for rf in runs),
                  "the background loads")
        # idempotent: nothing cold left to schedule
        assert snap._prefetch_range(0, g.cfg.vmax) == 0
        snap.release()
    finally:
        g.close()


def test_prefetch_failure_surfaces_on_foreground_load(tmp_path):
    """A background load failure leaves the run cold; the foreground
    ensure_loaded loads again and raises the real error."""
    g = _durable_multi_run_store(tmp_path, n_runs=2)
    try:
        rf = g.levels[0][0]
        assert rf.evict()
        real_loader = rf.loader
        tried = threading.Event()

        def boom():
            tried.set()
            raise IOError("injected cold-load failure")

        rf.loader = boom
        assert rf.prefetch(prefetch_pool())
        assert tried.wait(30)
        _wait_for(lambda: not rf._prefetching, "the failed prefetch")
        assert rf.arrays is None
        tried.clear()
        with pytest.raises(IOError, match="injected"):
            rf.ensure_loaded()
        assert tried.is_set()
        rf.loader = real_loader
        rf.ensure_loaded()       # recovery path still works
    finally:
        g.close()


def test_chunked_resolve_under_concurrent_compaction(tmp_path):
    """A pinned snapshot resolving in chunks answers identically while
    compact_l0 rewrites the levels (and unlinks replaced files) underneath
    it — the pin + re-materialize contract, with prefetch in flight."""
    g = _durable_multi_run_store(tmp_path, n_runs=4, seed=3)
    try:
        snap = g.snapshot()
        vs = np.arange(0, 500)
        ref = snap.neighbors_batch(vs)
        snap._BATCH_CHUNK = 64           # force many chunks (+ trailing pad)
        started = threading.Event()

        def compactor():
            started.set()
            g.compact_l0()

        t = threading.Thread(target=compactor)
        t.start()
        assert started.wait(30)
        try:
            for _ in range(3):
                _evict_all(g)            # re-chill whatever reloaded
                g.drop_read_spine()
                got = snap.neighbors_batch(vs)
                for a, b in zip(ref, got):
                    np.testing.assert_array_equal(a, b)
        finally:
            t.join(timeout=120)
        assert not t.is_alive()
        assert g.levels[1] and not g.levels[0]
        _assert_batch_equals_scalar(snap, np.arange(0, 500, 7))
        snap.release()
    finally:
        g.close()


# --------------------------------------------------- against the reference
@pytest.mark.parametrize("legacy", [False, True])
def test_cold_reads_equal_reference(tmp_path, monkeypatch, legacy):
    """The same stream through a durable store of each package, every run
    evicted, then one chunked read of every vertex: byte-equal adjacency
    and properties, on the read spine and on the legacy path (whose
    prefetch is gated by the presence filters)."""
    if legacy:
        monkeypatch.setattr(port_store, "_READ_TOURNAMENT_MAX_K", 0)
        monkeypatch.setattr(jax_store, "_READ_TOURNAMENT_MAX_K", 0)
    cfg = small_store_cfg(l0_run_limit=3)
    j = _fill(jstorage.open_store(str(tmp_path / "j"), cfg,
                                  wal_sync="off"), 2, seed=5)
    p = _fill(open_store(str(tmp_path / "p"),
                         StoreConfig(**dataclasses.asdict(cfg)),
                         device="cpu", wal_sync="off"), 2, seed=5)
    for g in (j, p):
        g.compact_l0()
        g.insert_edges([1, 2], [3, 4])
        g.flush_memgraph()
    assert p.levels[0] and p.levels[1]
    vs = np.arange(0, 520)
    reads = []
    for g in (j, p):
        assert g.durability.evict_all_segments() == len(g.runs_by_fid)
        with g.snapshot() as snap:
            snap._BATCH_CHUNK = 128
            reads.append(snap.neighbors_batch(vs, return_props=True))
        assert all(rf.arrays is not None for rf in g.runs_by_fid.values())
    for v, (a, b) in enumerate(zip(*reads)):
        np.testing.assert_array_equal(a[0], b[0], err_msg=f"dst {v}")
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"prop {v}")
        assert a[0].dtype == b[0].dtype and a[1].dtype == b[1].dtype
    assert p.io.cold_load == j.io.cold_load > 0
    for g in (j, p):
        g.close()
