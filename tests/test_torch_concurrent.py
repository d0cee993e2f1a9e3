"""The port's ``ConcurrentLSMGraph`` and the store's lock-free snapshots
under concurrent writers, flushes and compactions.

Ports of the in-memory cases of the reference's ``tests/test_concurrent.py``
(mixed workload, a snapshot stable under writes, insert after close, readers
pinning oracle τs under flush/compaction churn with no writer lock taken on
the read path, the spliced spine equal to a from-scratch one, one spine per
epoch), of ``tests/test_read_batch.py::
test_concurrent_writer_error_surfaces_on_next_call`` and of the wrapper's
failure reporting.  Every read is held against a numpy last-writer-wins
oracle of the records below its snapshot's τ (the JAX package's wrapper
interleaves differently, so its run layout is no oracle).  A durable store
wrapped by ``ConcurrentLSMGraph`` must reopen to what its snapshots read.
Every wait on a thread is bounded.  Tolerance: none (integer reads).
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import StoreConfig  # noqa: E402
from repro_torch.core import store as store_mod  # noqa: E402
from repro_torch.core.concurrent import ConcurrentLSMGraph  # noqa: E402
from repro_torch.core.store import LSMGraph  # noqa: E402
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


def pcfg(**kw):
    return StoreConfig(**dataclasses.asdict(small_store_cfg(**kw)))


def _wait_for(cond, what, limit=30.0):
    deadline = time.monotonic() + limit
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def test_mixed_workload_equals_sequential_store():
    """Five insert batches through the wrapper, a reader between them; the
    final reads equal the insert set and a sequential store's reads on the
    same stream, byte for byte."""
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 2000, 2500).astype(np.int32),
                rng.integers(0, 2000, 2500).astype(np.int32))
               for _ in range(5)]
    ref = {}
    for src, dst in batches:
        for s, d in zip(src, dst):
            ref.setdefault(int(s), set()).add(int(d))
    g = ConcurrentLSMGraph(pcfg(hash_slots=1 << 12), device="cpu")
    seq = LSMGraph(pcfg(hash_slots=1 << 12), device="cpu")
    for src, dst in batches:
        g.insert_edges(src, dst)
        seq.insert_edges(src, dst)
        with g.snapshot() as snap:   # concurrent reader mid-stream
            snap.neighbors(int(src[0]))
    g.close()
    vs = np.array(sorted(ref)[:120])
    with g.store.snapshot() as snap, seq.snapshot() as want:
        got = snap.neighbors_batch(vs)
        for v, a, b in zip(vs, got, want.neighbors_batch(vs)):
            assert set(int(x) for x in a) == ref[int(v)]
            np.testing.assert_array_equal(a, b)


def test_snapshot_stable_under_concurrent_writes():
    rng = np.random.default_rng(2)
    g = ConcurrentLSMGraph(pcfg(), device="cpu")
    g.insert_edges([7, 7], [1, 2])
    g.flush()
    snap = g.snapshot()
    want = set(int(x) for x in snap.neighbors(7))
    flushes = obs.REGISTRY.histogram("store_flush_seconds",
                                     store=g.store.obs_label)
    n0 = flushes.count
    g.insert_edges(rng.integers(0, 500, 4000), rng.integers(0, 500, 4000))
    g.insert_edges([7], [3])
    g.flush()
    # The compactor churns behind the snapshot: wait for a flush of it.
    _wait_for(lambda: flushes.count > n0, "a background flush")
    assert set(int(x) for x in snap.neighbors(7)) == want == {1, 2}
    snap.release()
    g.close()
    with g.store.snapshot() as s:
        assert {1, 2, 3} <= set(int(x) for x in s.neighbors(7))


def test_insert_after_close_raises():
    g = ConcurrentLSMGraph(pcfg(), device="cpu")
    g.insert_edges([1], [2])
    g.close()
    with pytest.raises(RuntimeError):
        g.insert_edges([3], [4])


def test_concurrent_writer_error_surfaces_on_next_call():
    """A background writer failure surfaces as RuntimeError on the next
    insert_edges/flush, not vanishing into the thread; it is recorded with
    its work item and counted."""
    g = ConcurrentLSMGraph(pcfg(), device="cpu")
    g.insert_edges([1], [2])
    g.flush()
    before = obs.REGISTRY.counter("store_background_errors_total",
                                  thread="writer").value

    def boom(*a, **k):
        raise ValueError("injected writer failure")

    g.store._apply_no_flush = boom
    g.insert_edges([3], [4])           # queued; writer thread hits boom
    with pytest.raises(RuntimeError):
        g.flush()
    with pytest.raises(RuntimeError):
        g.insert_edges([5], [6])
    err = g.last_errors["writer"]
    assert err["work"] == "insert batch of 1"
    assert "injected writer failure" in err["error"]
    assert obs.REGISTRY.counter("store_background_errors_total",
                                thread="writer").value == before + 1


def test_close_reports_wedged_compactor(monkeypatch):
    g = ConcurrentLSMGraph(pcfg(), device="cpu")
    release = threading.Event()
    monkeypatch.setattr(ConcurrentLSMGraph, "_WRITER_JOIN_TIMEOUT", 0.5)
    monkeypatch.setattr(ConcurrentLSMGraph, "_COMPACTOR_JOIN_TIMEOUT", 0.5)
    monkeypatch.setattr(g.store, "flush_memgraph", lambda: release.wait(30))
    monkeypatch.setattr("repro_torch.core.memgraph.memgraph_should_flush",
                        lambda mem, cfg: True)
    g._compact_request.set()
    _wait_for(lambda: g._busy["compactor"] is not None,
              "the compactor to enter the wedged flush")
    with pytest.raises(RuntimeError, match=r"leaked background.*compactor"
                                           r".*flush_memgraph"):
        g.close()
    release.set()
    g._writer.join(timeout=5)
    g._compactor.join(timeout=5)
    assert not g._compactor.is_alive()
    g.store.close()


# ===================== epoch-published StoreState stress suite =============

def _make_edge_log(n, vmax, seed, del_every=7):
    """Deterministic single-writer record log: record i is applied with
    ts == i, so a snapshot pinned at tau == T sees EXACTLY the first T
    records — the per-tau oracle."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vmax, n).astype(np.int64)
    dst = rng.integers(0, vmax, n).astype(np.int64)
    delete = np.zeros(n, bool)
    for i in range(del_every, n, del_every):
        j = int(rng.integers(0, i))
        src[i], dst[i], delete[i] = src[j], dst[j], True
    return src, dst, delete


def _oracle_adjacency(src, dst, delete, tau, queries):
    """Live adjacency per query vertex from the first ``tau`` log records
    (last record per (src, dst) key wins)."""
    state = {}
    for i in range(int(tau)):
        state[(int(src[i]), int(dst[i]))] = not delete[i]
    out = {int(q): set() for q in queries}
    for (u, v), live in state.items():
        if live and u in out:
            out[u].add(v)
    return out


class _LockSpy:
    """Context-manager proxy over a store lock: records which THREAD
    acquires it, then delegates."""

    def __init__(self, inner, name, log):
        self._inner, self._name, self._log = inner, name, log

    def acquire(self, *a, **k):
        self._log.append((threading.current_thread().name, self._name))
        return self._inner.acquire(*a, **k)

    def release(self):
        return self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self._inner.release()
        return False


def _spy_on_writer_locks(g: LSMGraph):
    log = []
    for name in ("_lock", "_write_lock", "_flush_lock", "_compact_lock"):
        setattr(g, name, _LockSpy(getattr(g, name), name, log))
    return log


def _apply_log(g, src, dst, delete, lo, hi):
    """Apply records [lo, hi) in log order, in runs of one op."""
    i = lo
    while i < hi:
        j = i
        while j < hi and delete[j] == delete[i]:
            j += 1
        if delete[i]:
            g.delete_edges(src[i:j], dst[i:j])
        else:
            g.insert_edges(src[i:j], dst[i:j])
        i = j


def test_readers_pin_oracle_taus_under_flush_compact_churn():
    """Reader threads snapshot + resolve while one writer ingests the
    deterministic log and the main thread forces flush + compaction
    churn.  Every pinned tau serves the log-prefix oracle, and no reader
    thread ever acquires a store writer lock."""
    cfg = pcfg(hash_slots=1 << 13, ovf_cap=1 << 13)
    g = LSMGraph(cfg, device="cpu")
    lock_log = _spy_on_writer_locks(g)
    n = 6000
    src, dst, delete = _make_edge_log(n, vmax=cfg.vmax, seed=11)
    queries = np.unique(src[:256] % cfg.vmax)[:32]
    stop = threading.Event()
    failures = []
    reads = [0]

    def writer():
        try:
            for lo in range(0, n, 300):
                _apply_log(g, src, dst, delete, lo, min(n, lo + 300))
        except BaseException as e:  # surface to the main thread
            failures.append(e)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                with g.snapshot() as snap:
                    tau = snap.tau
                    res = snap.neighbors_batch(queries)
                want = _oracle_adjacency(src, dst, delete, tau, queries)
                for q, r in zip(queries, res):
                    got = set(int(x) for x in np.asarray(r))
                    if got != want[int(q)]:
                        failures.append(AssertionError(
                            f"tau={tau} v={int(q)}: got {sorted(got)} "
                            f"!= want {sorted(want[int(q)])}"))
                        return
                reads[0] += 1
        except BaseException as e:
            failures.append(e)

    readers = [threading.Thread(target=reader, name=f"reader-{i}")
               for i in range(3)]
    wr = threading.Thread(target=writer, name="stress-writer")
    for t in readers:
        t.start()
    wr.start()
    while not stop.is_set():
        g.flush_memgraph()
        g.compact_l0()
        stop.wait(0.01)
    wr.join(timeout=120)
    for t in readers:
        t.join(timeout=120)
    assert not wr.is_alive() and not any(t.is_alive() for t in readers)
    assert not failures, failures[0]
    assert reads[0] > 0
    reader_acquisitions = [(thr, lk) for thr, lk in lock_log
                           if thr.startswith("reader-")]
    assert reader_acquisitions == [], reader_acquisitions
    assert lock_log, "spy saw no writer activity — test is vacuous"
    with g.snapshot() as snap:
        want = _oracle_adjacency(src, dst, delete, n, queries)
        for q, r in zip(queries, snap.neighbors_batch(queries)):
            assert set(int(x) for x in np.asarray(r)) == want[int(q)]


def test_spliced_spine_equals_from_scratch():
    """Flush/compaction publishes splice ONLY the changed run streams into
    the previous merged spine; the result is byte-identical (valid prefix,
    rids through their fid mapping) to a from-scratch merge."""
    cfg = pcfg()
    g = LSMGraph(cfg, device="cpu")
    rng = np.random.default_rng(5)
    queries = np.arange(0, cfg.vmax, 97, dtype=np.int64)

    def warm():
        with g.snapshot() as snap:
            snap.neighbors_batch(queries)  # forces the spine build
            return snap.state

    for _ in range(4):
        g.insert_edges(rng.integers(0, cfg.vmax, 1500),
                       rng.integers(0, cfg.vmax, 1500))
        g.flush_memgraph()
        warm()
    g.compact_l0()
    st = warm()
    bb_incremental = st.spine.get(st, g)
    old_cache = g._spine_cache
    try:
        g._spine_cache = store_mod._SpineCache(g.device)
        bb_scratch = store_mod._build_state_backbone(st, g)
    finally:
        g._spine_cache = old_cache

    def canon(bb):
        s_np = bb.src.numpy()
        valid = s_np != store_mod.INVALID_VID
        fid_of = bb.run_fid.numpy().astype(np.int64)
        rid = bb.rid.numpy()[valid]
        fid = np.where(rid < 0, -1,
                       fid_of[np.clip(rid, 0, max(len(fid_of) - 1, 0))])
        return (s_np[valid], bb.dst.numpy()[valid], bb.ts.numpy()[valid],
                fid, bb.marker.numpy()[valid], bb.prop.numpy()[valid])

    for a, b in zip(canon(bb_incremental), canon(bb_scratch)):
        np.testing.assert_array_equal(a, b)


def test_snapshots_share_one_spine_per_epoch():
    """Snapshots at one epoch share ONE spine handle (built at most once); a
    plain apply carries the handle forward, a flush installs a fresh one."""
    g = LSMGraph(pcfg(), device="cpu")
    g.insert_edges([1, 2, 3], [4, 5, 6])
    g.flush_memgraph()
    s1, s2 = g.snapshot(), g.snapshot()
    assert s1.state.spine is s2.state.spine
    b1 = s1._get_backbone()
    assert s2.spine_ready()
    assert s2._get_backbone() is b1
    g.insert_edges([7], [8])
    s3 = g.snapshot()
    assert s3.state.spine is s1.state.spine
    g.flush_memgraph()
    s4 = g.snapshot()
    assert s4.state.spine is not s1.state.spine
    for s in (s1, s2, s3, s4):
        s.release()


# ------------------------------------------------------- a durable wrapper
def test_durable_concurrent_store_reopens_to_its_reads(tmp_path):
    """``open_store`` wrapped by ``ConcurrentLSMGraph``: a reader thread
    pins snapshots while the log streams in (each read equal to the
    oracle at its τ); ``close()`` leaves a WAL tail; the reopened store
    reads the whole log's oracle."""
    cfg = pcfg(hash_slots=1 << 13, ovf_cap=1 << 13)
    g = ConcurrentLSMGraph(store=open_store(str(tmp_path / "db"), cfg,
                                            device="cpu"))
    assert g.store.durability.wal.sync_mode == "batch"
    n = 5000
    src, dst, delete = _make_edge_log(n, vmax=cfg.vmax, seed=4)
    queries = np.unique(src[:200])[:40]
    failures, taus = [], []
    done = threading.Event()

    def reader():
        try:
            while not done.is_set() or len(taus) < 3:
                with g.snapshot() as snap:
                    tau = snap.tau
                    res = snap.neighbors_batch(queries)
                want = _oracle_adjacency(src, dst, delete, tau, queries)
                for q, r in zip(queries, res):
                    assert set(int(x) for x in r) == want[int(q)], (tau, q)
                taus.append(tau)
        except BaseException as e:
            failures.append(e)

    t = threading.Thread(target=reader, name="reader")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)   # interleave the three threads finely
    try:
        t.start()
        for lo in range(0, n, 250):
            _apply_log(g, src, dst, delete, lo, min(n, lo + 250))
        g.flush()
    finally:
        done.set()
        sys.setswitchinterval(switch)
    t.join(timeout=120)
    assert not t.is_alive() and not failures, failures[:1]
    assert len(taus) >= 3
    assert g.store.level_sizes()[1] > 0
    assert int(g.store.mem.ne) > 0        # close() leaves a WAL tail
    g.close()
    g2 = open_store(str(tmp_path / "db"), device="cpu")
    want = _oracle_adjacency(src, dst, delete, n, queries)
    with g2.snapshot() as snap:
        for q, r in zip(queries, snap.neighbors_batch(queries)):
            assert set(int(x) for x in r) == want[int(q)]
    g2.close()
