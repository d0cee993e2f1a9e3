"""The port's sharded store (``repro_torch.shard``) against the JAX package's.

Ports of the cases of the reference's ``tests/test_shard.py`` (all but the
mesh write router, which waits for ``core/distributed.py``), of the three
scheduler cases of ``tests/test_filters.py``, and of the sharded cases of
``test_read_pipeline.py`` (cold reads), ``test_concurrent.py`` (readers
through a fence) and ``test_chaos.py`` (degraded mode and heal, a shard's
lost durability).  Each sharded read of the port is held against a port
store holding the whole graph and against the JAX package's
``ShardedGraphStore`` on the same stream: neighbor lists, props, membership,
receipts and degraded reports byte-equal.  A durable sharded directory
written by either package opens in the other with equal reads.  Every
wait on a thread is bounded.  Tolerance: none (integer and float32 props
compared exactly).
"""
import dataclasses
import glob
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import shard as jshard  # noqa: E402
from repro.shard.scheduler import CompactionScheduler as JScheduler  # noqa
from repro.storage import faultfs as jfaultfs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core import StoreConfig  # noqa: E402
from repro_torch.core.store import LSMGraph  # noqa: E402
from repro_torch.shard import (CompactionScheduler,  # noqa: E402
                               DegradedReport, RangePartition,
                               ShardedGraphStore, ShardUnavailable,
                               bucket_edge_batches, open_sharded_store,
                               route_queries, shard_scaled_config)
from repro_torch.storage import faultfs  # noqa: E402
from repro_torch.storage.errors import (CorruptionError,  # noqa: E402
                                        DurabilityLost)


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


def _durable_cfg(port=True, **kw):
    base = dict(vmax=1 << 12, mem_edges=1 << 12, l0_run_limit=64)
    base.update(kw)
    if port:
        return StoreConfig(**base)
    from repro.core.types import StoreConfig as JStoreConfig
    return JStoreConfig(**base)


def _sharded(n_shards, **kw):
    return ShardedGraphStore(pcfg(), n_shards, device="cpu", **kw)


def _open(root, cfg=None, **kw):
    return open_sharded_store(str(root), cfg, device="cpu", **kw)


def _random_graph(seed, n_edges=4000, vmax=1 << 12):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vmax, n_edges).astype(np.int64)
    dst = rng.integers(0, vmax, n_edges).astype(np.int64)
    prop = rng.random(n_edges).astype(np.float32)
    return src, dst, prop


def _apply(stores, src, dst, prop, seed, with_deletes=True):
    for g in stores:
        g.insert_edges(src, dst, prop)
    if with_deletes:
        rng = np.random.default_rng(seed + 1)
        di = rng.choice(len(src), len(src) // 10, replace=False)
        for g in stores:
            g.delete_edges(src[di], dst[di])


def _build_triple(n_shards, seed=0, with_deletes=True):
    """The same update history applied to the port's sharded store, a port
    store holding the whole graph, and the JAX package's sharded store."""
    src, dst, prop = _random_graph(seed)
    sharded = _sharded(n_shards)
    oracle = LSMGraph(pcfg(), device="cpu")
    ref = jshard.ShardedGraphStore(small_store_cfg(), n_shards)
    _apply((sharded, oracle, ref), src, dst, prop, seed, with_deletes)
    return sharded, oracle, ref


def _same_lists(got, want, what=""):
    assert len(got) == len(want), what
    for i, (b, a) in enumerate(zip(got, want)):
        if isinstance(a, tuple):
            np.testing.assert_array_equal(b[0], a[0], err_msg=f"{what} {i}")
            np.testing.assert_array_equal(b[1], a[1], err_msg=f"{what} {i}")
            assert b[0].dtype == a[0].dtype and b[1].dtype == a[1].dtype
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {i}")
            assert b.dtype == a.dtype, what


# ------------------------------------------------------------------ partition
def test_partition_ranges_cover_vmax_exactly_once():
    for n in (1, 2, 3, 4, 7, 8):
        part = RangePartition.for_vmax(1000, n)
        ref = jshard.RangePartition.for_vmax(1000, n)
        assert dataclasses.astuple(part) == dataclasses.astuple(ref)
        seen = []
        for s in range(n):
            lo, hi = part.shard_range(s)
            assert (lo, hi) == ref.shard_range(s)
            seen.extend(range(lo, hi))
        assert seen == list(range(1000))
        owner = part.owner_of(np.arange(1000))
        np.testing.assert_array_equal(owner, ref.owner_of(np.arange(1000)))
        for s in range(n):
            lo, hi = part.shard_range(s)
            assert (owner[lo:hi] == s).all()


def test_partition_out_of_range_owns_nothing():
    part = RangePartition.for_vmax(100, 4)
    assert part.owner_of(np.array([-1, 100, 5000])).tolist() == [-1, -1, -1]
    with pytest.raises(ValueError):
        RangePartition.for_vmax(100, 0)


def test_split_by_owner_roundtrip_with_duplicates():
    part = RangePartition.for_vmax(100, 3)
    vs = np.array([5, 99, 5, 42, -7, 5, 200, 0])
    per_vids, per_pos = part.split_by_owner(vs)
    ref_vids, ref_pos = jshard.RangePartition.for_vmax(
        100, 3).split_by_owner(vs)
    for a, b in zip(per_vids + per_pos, ref_vids + ref_pos):
        np.testing.assert_array_equal(a, b)
    out = np.full(len(vs), -1, np.int64)
    for vids, pos in zip(per_vids, per_pos):
        out[pos] = vids
    keep = part.owner_of(vs) >= 0
    np.testing.assert_array_equal(out[keep], vs[keep])
    assert (out[~keep] == -1).all()


def test_route_queries_positions_are_inverse_permutation():
    part = RangePartition.for_vmax(90, 3)
    vs = np.array([80, 3, 80, 45, -2, 3, 91, 0])
    per_vs, per_pos, n = route_queries(part, vs)
    ref = jshard.route_queries(jshard.RangePartition.for_vmax(90, 3), vs)
    assert n == ref[2] == len(vs)
    for a, b in zip(per_vs + per_pos, ref[0] + ref[1]):
        np.testing.assert_array_equal(a, b)
    out = np.full(n, -1, np.int64)
    for vids, pos in zip(per_vs, per_pos):   # scatter back by position
        out[pos] = vids
    owner = part.owner_of(vs)
    np.testing.assert_array_equal(out[owner >= 0], vs[owner >= 0])
    assert (out[owner < 0] == -1).all()      # no-shard ids touched nowhere


def test_bucket_edges_matches_reference_and_rejects_unowned_sources():
    part = RangePartition.for_vmax(100, 3)
    src, dst, prop = _random_graph(4, n_edges=50, vmax=100)
    got = bucket_edge_batches(part, src, dst, prop)
    want = jshard.bucket_edge_batches(
        jshard.RangePartition.for_vmax(100, 3), src, dst, prop)
    assert [b is None for b in got] == [b is None for b in want]
    for b, a in zip(got, want):
        if a is not None:
            for x, y in zip(b, a):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    with pytest.raises(ValueError):
        bucket_edge_batches(RangePartition.for_vmax(100, 2), [5, 500], [1, 2])


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7, 16])
def test_shard_scaled_config_matches_reference(n_shards):
    cfg = pcfg()
    got = shard_scaled_config(cfg, n_shards)
    want = jshard.shard_scaled_config(small_store_cfg(), n_shards)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    got.validate()


# ------------------------------------------------------- oracle equivalence
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_sharded_reads_match_oracle(n_shards):
    sharded, oracle, ref = _build_triple(n_shards, seed=n_shards)
    rng = np.random.default_rng(99)
    # duplicates, unsorted, absent ids, and no-shard ids (>= vmax, negative)
    qs = np.concatenate([
        rng.integers(0, 1 << 12, 400), [7, 7, 7, 0, (1 << 12) - 1],
        [1 << 13, -5, 1 << 12]]).astype(np.int64)
    us = qs[:200]
    vs = rng.integers(0, 1 << 12, 200).astype(np.int64)
    with oracle.snapshot() as osnap:
        want = osnap.neighbors_batch(qs)
        got = sharded.sharded_neighbors_batch(qs)
        _same_lists(got, want, "port store")
        _same_lists(got, ref.sharded_neighbors_batch(qs), "JAX sharded")
        member = sharded.sharded_query_edges_batch(us, vs)
        np.testing.assert_array_equal(member,
                                      osnap.query_edges_batch(us, vs))
        np.testing.assert_array_equal(member,
                                      ref.sharded_query_edges_batch(us, vs))
    assert sharded.level_sizes() == ref.level_sizes()
    sharded.close()
    ref.close()


def test_sharded_single_vertex_fast_path_matches_oracle():
    """A 1-unique-vertex batch takes the owning shard's scalar shortcut —
    results must still equal the oracle and the JAX package's, incl. the
    no-shard case."""
    sharded, oracle, ref = _build_triple(4, seed=23)
    with oracle.snapshot() as osnap:
        for v in (0, 7, (1 << 12) - 1, 1 << 13, -4):
            got = sharded.sharded_neighbors_batch([v, v])
            _same_lists(got, osnap.neighbors_batch([v, v]), f"vertex {v}")
            _same_lists(got, ref.sharded_neighbors_batch([v, v]),
                        f"JAX vertex {v}")
        got = sharded.sharded_neighbors_batch([7], return_props=True)
        _same_lists(got, osnap.neighbors_batch([7], return_props=True))
        _same_lists(got, ref.sharded_neighbors_batch([7], return_props=True))
    with sharded.snapshot() as s, ref.snapshot() as r:
        got, rep = s.neighbors_batch([7, 7], with_report=True)
        want, wrep = r.neighbors_batch([7, 7], with_report=True)
        _same_lists(got, want)
        assert rep.ok and wrep.ok and rep.shards == wrep.shards == ()
    sharded.close()
    ref.close()


def test_sharded_props_match_oracle():
    sharded, oracle, ref = _build_triple(4, seed=17)
    qs = np.arange(0, 1 << 12, 13)
    with oracle.snapshot() as osnap, sharded.snapshot() as ssnap, \
            ref.snapshot() as rsnap:
        got = ssnap.neighbors_batch(qs, return_props=True)
        _same_lists(got, osnap.neighbors_batch(qs, return_props=True))
        _same_lists(got, rsnap.neighbors_batch(qs, return_props=True))
        np.testing.assert_array_equal(ssnap.degrees_batch(qs),
                                      rsnap.degrees_batch(qs))
        assert ssnap.edge_set() == rsnap.edge_set() == osnap.edge_set()
        assert ssnap.taus == rsnap.taus and ssnap.epoch == rsnap.epoch
    sharded.close()
    ref.close()


def _check_random_shard_roundtrip(n_shards, seed):
    """One property example: random graph + deletes, random query mix with
    no-shard ids and guaranteed duplicates, sharded == oracle elementwise."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 600))
    src = rng.integers(0, 1 << 12, n).astype(np.int64)
    dst = rng.integers(0, 1 << 12, n).astype(np.int64)
    sharded = _sharded(n_shards)
    oracle = LSMGraph(pcfg(), device="cpu")
    sharded.insert_edges(src, dst)
    oracle.insert_edges(src, dst)
    nd = int(rng.integers(0, n // 2 + 1))
    if nd:
        di = rng.choice(n, nd, replace=False)
        sharded.delete_edges(src[di], dst[di])
        oracle.delete_edges(src[di], dst[di])
    qs = np.concatenate([
        rng.integers(-8, (1 << 12) + 8, 64),
        rng.choice(src, min(16, n)),          # guaranteed hits + duplicates
    ]).astype(np.int64)
    with oracle.snapshot() as osnap:
        _same_lists(sharded.sharded_neighbors_batch(qs),
                    osnap.neighbors_batch(qs), (n_shards, seed))
    sharded.close()


def test_sharded_property_random_shard_counts():
    """Property sweep over random shard counts / graphs / query mixes,
    drawn from a fixed meta-seed."""
    meta = np.random.default_rng(2024)
    for _ in range(6):
        _check_random_shard_roundtrip(int(meta.integers(1, 7)),
                                      int(meta.integers(0, 10_000)))


def test_sharded_property_hypothesis():
    """The same property under hypothesis' adversarial example search."""
    pytest.importorskip("hypothesis", reason="property sweep needs hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=10, deadline=None)
    @given(n_shards=st.integers(1, 6), seed=st.integers(0, 1000))
    def check(n_shards, seed):
        _check_random_shard_roundtrip(n_shards, seed)

    check()


def test_sharded_reads_consistent_under_concurrent_writes():
    """Byte-identity holds while a writer keeps mutating: snapshots pinned
    at the same stream position answer identically even as both stores
    ingest more batches underneath the pinned views."""
    sharded = _sharded(4)
    oracle = LSMGraph(pcfg(), device="cpu")
    apply_lock = threading.Lock()   # both-stores-at-same-prefix invariant
    stop = threading.Event()
    rng = np.random.default_rng(5)
    src, dst, _ = _random_graph(5, n_edges=2000)
    sharded.insert_edges(src, dst)
    oracle.insert_edges(src, dst)

    def writer():
        wrng = np.random.default_rng(6)
        while not stop.is_set():
            s = wrng.integers(0, 1 << 12, 64).astype(np.int64)
            d = wrng.integers(0, 1 << 12, 64).astype(np.int64)
            with apply_lock:
                sharded.insert_edges(s, d)
                oracle.insert_edges(s, d)

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(5):
            with apply_lock:   # pin both views at an identical prefix
                osnap = oracle.snapshot()
                ssnap = sharded.snapshot()
            # resolve OUTSIDE the lock: the writer keeps appending while
            # these pinned snapshots answer.
            qs = rng.integers(0, 1 << 12, 128).astype(np.int64)
            _same_lists(ssnap.neighbors_batch(qs), osnap.neighbors_batch(qs))
            osnap.release()
            ssnap.release()
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
    sharded.close()


def test_epoch_snapshot_never_splits_a_batch():
    """A write batch spanning shards is visible on ALL its owner shards or
    none: mirrored edge pairs (u->v on shard 0, v->u on shard 3) must appear
    atomically in every snapshot taken concurrently with the writes."""
    sharded = _sharded(4)
    lo0 = 5                      # shard 0 territory
    hi3 = (1 << 12) - 5          # shard 3 territory
    stop = threading.Event()
    errors = []

    def writer():
        k = 0
        while not stop.is_set() and k < 200:
            # one batch holding BOTH directions: routed to two shards
            sharded.insert_edges([lo0, hi3], [hi3, lo0],
                                 prop=[float(k), float(k)])
            k += 1

    def reader():
        while not stop.is_set():
            with sharded.snapshot() as snap:
                has = snap.query_edges_batch([lo0, hi3], [hi3, lo0])
                if has[0] != has[1]:
                    errors.append(tuple(has))
                    return

    tw = threading.Thread(target=writer)
    tr = threading.Thread(target=reader)
    tw.start()
    tr.start()
    tw.join(timeout=60)
    stop.set()
    tr.join(timeout=30)
    assert not tw.is_alive() and not tr.is_alive()
    assert not errors, f"snapshot observed half a routed batch: {errors[0]}"
    sharded.close()


# --------------------------------------------------------------- WAL + acks
def test_ack_after_close_is_safe(tmp_path):
    """Acking a receipt after close() completes cleanly: close fsynced
    every WAL, so the (inline-fallback) waits see the seqs durable."""
    g = _open(tmp_path / "sh", pcfg(), n_shards=2, wal_sync="batch",
              wal_sync_interval=30.0)
    r = g.insert_edges([1, 3000], [2, 4])
    g.close()
    g.ack(r)


def test_sharded_receipt_and_ack(tmp_path):
    """Receipts name exactly the touched shards, with the JAX package's
    epochs and commit seqs on the same writes; acks land and the directory
    reopens to every acked edge."""
    g = _open(tmp_path / "sh", pcfg(), n_shards=3, wal_sync="batch",
              wal_sync_interval=30.0)
    ref = jshard.open_sharded_store(str(tmp_path / "ref"), small_store_cfg(),
                                    n_shards=3, wal_sync="batch",
                                    wal_sync_interval=30.0)
    part = g.part
    # a batch touching only shard 0: receipt names shard 0 alone
    lo, hi = part.shard_range(0)
    r0 = g.insert_edges([lo, lo + 1], [hi - 1, lo])
    assert set(r0.seqs) == {0}
    # a batch spanning all shards
    srcs = [part.shard_range(s)[0] for s in range(3)]
    r_all = g.insert_edges(srcs, [x + 1 for x in srcs])
    assert set(r_all.seqs) == {0, 1, 2}
    assert r_all.epoch > r0.epoch
    w0 = ref.insert_edges([lo, lo + 1], [hi - 1, lo])
    w_all = ref.insert_edges(srcs, [x + 1 for x in srcs])
    assert (tuple(r0), tuple(r_all)) == (tuple(w0), tuple(w_all))
    g.ack(r0)
    g.ack(r_all)
    ref.ack(w0)
    ref.ack(w_all)
    g.close()
    ref.close()
    g2 = _open(tmp_path / "sh")
    assert g2.n_shards == 3
    with g2.snapshot() as snap:
        assert len(snap.edge_set()) == 5
    g2.close()


def test_failed_shard_apply_drains_siblings_before_raising():
    """One shard's apply failing must propagate AFTER every sibling future
    completes: the epoch lock never releases with sub-batches in flight,
    and the store stays usable."""
    g = _sharded(4)
    boom_shard = g.shards[1]
    orig = boom_shard.insert_edges
    boom_shard.insert_edges = lambda *a, **k: (_ for _ in ()).throw(
        ValueError("injected shard failure"))
    lo = [g.part.shard_range(s)[0] for s in range(4)]
    with pytest.raises(ValueError, match="injected"):
        g.insert_edges(lo, [x + 1 for x in lo])   # spans all four shards
    boom_shard.insert_edges = orig
    with g.snapshot() as snap:                    # no deadlock, no torn pin
        got = snap.query_edges_batch(lo, [x + 1 for x in lo])
        assert got.tolist() == [True, False, True, True]
    g.close()


def test_snapshot_readable_after_store_close():
    """A pinned ShardedSnapshot keeps answering after close() — the
    single-store contract ('the store stays usable for reads')."""
    g = _sharded(3)
    g.insert_edges([1, 2000, 4000], [5, 6, 7])
    snap = g.snapshot()
    g.close()
    got = snap.neighbors_batch(np.array([1, 2000, 4000, 9]))
    assert [x.tolist() for x in got] == [[5], [6], [7], []]
    np.testing.assert_array_equal(
        snap.query_edges_batch([1, 2000], [5, 9]), [True, False])
    snap.release()


def test_torn_shard_meta_is_recreatable(tmp_path):
    """A crash during the very first create may leave a torn SHARDS.json
    with no shard dirs: reopening must recreate, not crash.  With shard
    dirs present, a torn meta refuses to guess."""
    root = tmp_path / "sh"
    root.mkdir()
    (root / "SHARDS.json").write_text('{"n_shards": ')   # torn write
    g = _open(root, pcfg(), n_shards=2)
    g.insert_edges([1], [2])
    g.close()
    g2 = _open(root)                                     # clean reopen
    assert g2.n_shards == 2
    g2.close()
    (root / "SHARDS.json").write_text("garbage")
    with pytest.raises(ValueError):
        _open(root)


def test_missing_meta_heals_from_shard_dirs(tmp_path):
    """SHARDS.json lands LAST at create; a crash before it leaves shard
    dirs without a meta — the no-arg reopen infers the count and heals,
    writing the reference's meta bytes."""
    root = tmp_path / "sh"
    g = _open(root, pcfg(), n_shards=3)
    g.insert_edges([1, 2000], [2, 3])
    g.close()
    meta = (root / "SHARDS.json").read_bytes()
    (root / "SHARDS.json").unlink()       # simulate the crash window
    g2 = _open(root)
    assert g2.n_shards == 3
    with g2.snapshot() as snap:
        assert snap.query_edges_batch([1, 2000], [2, 3]).all()
    g2.close()
    assert (root / "SHARDS.json").read_bytes() == meta   # healed
    jroot = tmp_path / "ref"
    jshard.open_sharded_store(str(jroot), small_store_cfg(),
                              n_shards=3).close()
    assert (jroot / "SHARDS.json").read_bytes() == meta


def test_crashed_create_retry_completes_layout(tmp_path):
    """Retrying the ORIGINAL create (same n_shards) after a mid-create
    crash completes the empty layout; once data exists, an explicit grown
    count is refused (it would rewire the partition)."""
    root = tmp_path / "sh"
    cfg = pcfg()
    g = _open(root, cfg, n_shards=2)     # "half-created":
    g.close()                            # no data, and...
    (root / "SHARDS.json").unlink()      # ...meta never landed
    g2 = _open(root, cfg, n_shards=4)    # retry, larger
    assert g2.n_shards == 4
    g2.insert_edges([1, 3500], [2, 4])
    g2.close()
    (root / "SHARDS.json").unlink()
    with pytest.raises(ValueError, match="hold data"):
        _open(root, cfg, n_shards=6)     # data present now
    g3 = _open(root)                     # no-arg adopt works
    assert g3.n_shards == 4
    g3.close()


def test_sharded_store_reopen_shard_count_mismatch(tmp_path):
    g = _open(tmp_path / "sh", pcfg(), n_shards=2)
    g.close()
    with pytest.raises(ValueError):
        _open(tmp_path / "sh", pcfg(), n_shards=4)


def test_sharded_store_without_device_needs_a_card(tmp_path):
    """``device=None`` asks for the current CUDA card, and raises without
    one (the port never falls back to the CPU on its own)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedGraphStore(pcfg(), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        open_sharded_store(str(tmp_path / "sh"), pcfg(), n_shards=2)
    assert not (tmp_path / "sh").exists()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_durable_sharded_directory_opens_in_the_other_package(tmp_path,
                                                               writer):
    """A durable sharded directory written by one package (inserts,
    deletes, flushes, a compaction and a WAL tail) opens in the other:
    the same shard count, level sizes and reads."""
    src, dst, prop = _random_graph(8, n_edges=3000)
    cfg_kw = dict(l0_run_limit=64)
    root = str(tmp_path / "sh")
    if writer == "port":
        w = _open(root, pcfg(**cfg_kw), n_shards=3, wal_sync="off")
    else:
        w = jshard.open_sharded_store(root, small_store_cfg(**cfg_kw),
                                      n_shards=3, wal_sync="off")
    _apply((w,), src[:2000], dst[:2000], prop[:2000], seed=8)
    w.flush_all()
    w.compact_all()
    w.insert_edges(src[2000:], dst[2000:], prop[2000:])   # WAL tail
    sizes = w.level_sizes()
    qs = np.arange(-3, (1 << 12) + 3, 7, dtype=np.int64)
    with w.snapshot() as s:
        want = s.neighbors_batch(qs, return_props=True)
    w.close()
    r = (jshard.open_sharded_store(root) if writer == "port"
         else _open(root))
    assert r.n_shards == 3
    assert r.level_sizes() == sizes
    with r.snapshot() as s:
        _same_lists(s.neighbors_batch(qs, return_props=True), want)
    r.close()


# ------------------------------------------------- empty-query short-circuits
def test_empty_query_vectors_short_circuit():
    """Length-0 query vectors return correctly-shaped, correctly-dtyped
    empties (single-store and sharded)."""
    sharded = _sharded(3)
    assert sharded.sharded_neighbors_batch([]) == []
    qe = sharded.sharded_query_edges_batch([], [])
    assert qe.shape == (0,) and qe.dtype == bool
    with sharded.snapshot() as snap:
        deg = snap.degrees_batch([])
        assert deg.shape == (0,) and deg.dtype == np.int64
        out, rep = snap.neighbors_batch([], with_report=True)
        assert out == [] and rep.ok and rep.positions.dtype == np.int64
    sharded.close()
    g = LSMGraph(pcfg(), device="cpu")
    qe = g.query_edges_batch([], [])
    assert qe.shape == (0,) and qe.dtype == bool


def test_query_edges_batch_shape_mismatch_raises():
    sharded = _sharded(2)
    with sharded.snapshot() as snap:
        with pytest.raises(ValueError):
            snap.query_edges_batch([1, 2], [3])
    sharded.close()


# ------------------------------------------------------------ cold reads
def test_sharded_cold_reads_equal_oracle(tmp_path):
    """Routed sharded reads with every shard's segments evicted cold equal
    a single-store oracle and the JAX package's cold sharded read (the
    prefetch fans out across shards)."""
    rng = np.random.default_rng(29)
    cfg = pcfg(l0_run_limit=100)
    src = rng.integers(0, cfg.vmax, 4000).astype(np.int64)
    dst = rng.integers(0, cfg.vmax, 4000).astype(np.int64)
    qs = rng.integers(0, cfg.vmax, 600).astype(np.int64)
    oracle = LSMGraph(cfg, device="cpu")
    oracle.insert_edges(src, dst)
    oracle.flush_memgraph()
    reads = []
    for make in (lambda: _open(tmp_path / "p", cfg, n_shards=4,
                               wal_sync="off"),
                 lambda: jshard.open_sharded_store(
                     str(tmp_path / "j"), small_store_cfg(l0_run_limit=100),
                     n_shards=4, wal_sync="off")):
        g = make()
        try:
            g.insert_edges(src, dst)
            g.flush_all()
            for sh in g.shards:
                assert sh.durability.evict_all_segments() > 0
            with g.snapshot() as ssnap:
                reads.append(ssnap.neighbors_batch(qs))
        finally:
            g.close()
    with oracle.snapshot() as osnap:
        _same_lists(reads[0], osnap.neighbors_batch(qs))
    _same_lists(reads[0], reads[1], "JAX cold read")


# --------------------------------------------------- concurrent fence
def test_sharded_readers_survive_concurrent_fence():
    """Readers keep resolving through a ShardedGraphStore while a shard is
    fenced mid-run: pinned sharded snapshots stay fully readable, new ones
    serve degraded (fenced range masked) without blocking on health state."""
    g = _sharded(4)
    cfg = g.cfg
    rng = np.random.default_rng(3)
    src = rng.integers(0, cfg.vmax, 3000).astype(np.int64)
    dst = rng.integers(0, cfg.vmax, 3000).astype(np.int64)
    g.insert_edges(src, dst)
    oracle = {}
    for u, v in zip(src, dst):
        oracle.setdefault(int(u), set()).add(int(v))
    queries = np.arange(0, cfg.vmax, 53, dtype=np.int64)
    pinned = g.snapshot()

    stop = threading.Event()
    failures = []

    def reader():
        try:
            while not stop.is_set():
                with g.snapshot() as snap:
                    res, rep = snap.neighbors_batch(queries,
                                                    with_report=True)
                masked = set(rep.positions.tolist())
                for i, q in enumerate(queries.tolist()):
                    if i in masked:
                        continue
                    got = set(int(x) for x in np.asarray(res[i]))
                    if got != oracle.get(q, set()):
                        failures.append(AssertionError(
                            f"v={q}: {sorted(got)} != "
                            f"{sorted(oracle.get(q, set()))}"))
                        return
        except BaseException as e:
            failures.append(e)

    threads = [threading.Thread(target=reader, name=f"shard-reader-{i}")
               for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    g.fence(2, CorruptionError("injected: concurrent fence"))
    time.sleep(0.15)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[0]

    # The pinned snapshot predates the fence: still answers EVERYTHING.
    res = pinned.neighbors_batch(queries)
    for q, r in zip(queries.tolist(), res):
        assert set(int(x) for x in np.asarray(r)) == oracle.get(q, set())
    pinned.release()
    # New snapshots mask exactly the fenced shard's range.
    with g.snapshot() as snap:
        _res, rep = snap.neighbors_batch(queries, with_report=True)
    assert rep.shards == (2,)
    lo, hi = g.part.shard_range(2)
    for pos in rep.positions.tolist():
        assert lo <= queries[pos] < hi
    assert g.health_report()[2]["status"] == "fenced"
    with pytest.raises(ShardUnavailable):
        g.insert_edges([lo], [1])
    g.close()


# ------------------------------------------------ degraded mode and heal
def _degraded_and_heal(root, open_fn, flip_fn, port):
    vmax = 4096
    g = open_fn(root, _durable_cfg(port=port, vmax=vmax), n_shards=4,
                wal_sync="always")
    rng = np.random.default_rng(1)
    src = rng.integers(0, vmax, 2000).astype(np.int64)
    dst = rng.integers(0, vmax, 2000).astype(np.int64)
    g.ack(g.insert_edges(src, dst))
    g.flush_all()
    with g.snapshot() as s:
        oracle = s.edge_set()
    seg = sorted(glob.glob(os.path.join(root, "shard-01", "segments",
                                        "*.csr")))[-1]
    flip_fn(seg)
    for sh in g.shards:
        sh.durability.evict_all_segments()
    qs = np.arange(0, vmax, 5, dtype=np.int64)
    with g.snapshot() as s:
        res, rep = s.neighbors_batch(qs, with_report=True)
    health = g.health_report()[1]["status"]
    with pytest.raises(Exception) as ei:
        g.insert_edges(np.array([g.part.shard_range(1)[0], 0], np.int64),
                       np.array([1, 2], np.int64))
    g.ack(g.insert_edges(np.array([0], np.int64), np.array([9], np.int64)))
    g.reopen_shard(1)
    fenced_after = g.fenced()
    with g.snapshot() as s:
        healed = s.edge_set()
    g.close()
    return dict(oracle=oracle, res=res, rep=rep, health=health,
                refused=ei.value, fenced_after=fenced_after, healed=healed,
                vmax=vmax, qs=qs)


def test_sharded_degraded_mode_and_reopen_heal(tmp_path):
    """One bit flipped in shard 1's newest segment, every run evicted: the
    read masks shard 1's range (the same positions, shards and reads as
    the JAX package's), writes to it get backpressure, and reopen_shard
    rebuilds the segment from the retained WAL back to the oracle."""
    got = _degraded_and_heal(str(tmp_path / "p"), _open, faultfs.flip_bit,
                             port=True)
    want = _degraded_and_heal(str(tmp_path / "j"),
                              jshard.open_sharded_store, jfaultfs.flip_bit,
                              port=False)
    rep = got["rep"]
    assert isinstance(rep, DegradedReport) and not rep.ok
    assert rep.shards == (1,) == want["rep"].shards
    np.testing.assert_array_equal(rep.positions, want["rep"].positions)
    assert [(r.lo, r.hi, r.fid) for r in rep.ranges] == \
        [(r.lo, r.hi, r.fid) for r in want["rep"].ranges]
    _same_lists(got["res"], want["res"])
    part = RangePartition.for_vmax(got["vmax"], 4)
    lo, hi = part.shard_range(1)
    masked = set(rep.positions.tolist())
    by_src = {}
    for (u, v) in got["oracle"]:
        by_src.setdefault(u, set()).add(v)
    for i, q in enumerate(got["qs"].tolist()):
        if i in masked:
            assert lo <= q < hi
        else:
            assert set(np.asarray(got["res"][i]).tolist()) == \
                by_src.get(q, set())
    assert got["health"] == "fenced" == want["health"]
    assert isinstance(got["refused"], ShardUnavailable)
    assert got["refused"].shards == (1,) == want["refused"].shards
    assert got["fenced_after"] == {}
    assert got["healed"] == got["oracle"] | {(0, 9)} == want["healed"]


def test_sharded_ack_attributes_durability_loss(tmp_path):
    """A latched shard's ack failure surfaces as DurabilityLost(shard=s),
    the shard fences, and sibling acks complete."""
    root = str(tmp_path / "shards")
    vmax = 1024
    g = _open(root, _durable_cfg(vmax=vmax), n_shards=2, wal_sync="batch",
              wal_sync_interval=30.0)
    with faultfs.fault_plan() as plan:
        plan.add(faultfs.FaultRule(op="fsync", match="shard-01/wal",
                                   count=-1))
        receipt = g.insert_edges(np.array([10, 600], np.int64),
                                 np.array([11, 601], np.int64))
        assert set(receipt.seqs) == {0, 1}
        with pytest.raises(DurabilityLost) as ei:
            g.ack(receipt)
        assert ei.value.shard == 1
    assert set(g.fenced()) == {1}
    # Shard 0's half of the batch is acked durable and writable.
    g.ack(g.insert_edges(np.array([20], np.int64), np.array([21], np.int64)))
    g.close()
    g2 = _open(root)
    with g2.snapshot() as s:
        assert {(10, 11), (20, 21)} <= s.edge_set()
    g2.close()


# -------------------------------------------------------------- scheduler
def _sharded_with_debt(n_runs=3, port=True):
    if port:
        g = ShardedGraphStore(pcfg(l0_run_limit=64), 2, device="cpu")
    else:
        g = jshard.ShardedGraphStore(small_store_cfg(l0_run_limit=64), 2)
    # Ingest + flush only into shard 0's range: it accrues L0 debt.
    lo, hi = g.part.shard_range(0)
    for i in range(n_runs):
        src = np.arange(lo, lo + 40, dtype=np.int64)
        g.insert_edges(src % (hi - lo) + lo, src + i + 1)
        g.shards[0].flush_memgraph()
    return g


def test_scheduler_compacts_worst_shard_then_idles():
    g = _sharded_with_debt()
    ref = _sharded_with_debt(port=False)
    sched, jsched = CompactionScheduler(g), JScheduler(ref)
    assert len(g.shards[0]._state.levels[0]) >= 2
    scores = sched.shard_scores()
    assert set(scores) == {0}                     # shard 1 has no debt
    assert scores == pytest.approx(jsched.shard_scores(), rel=1e-6)
    out = sched.step()
    assert out["decision"] == "compact" and out["shard"] == 0
    assert out == jsched.step()
    assert len(g.shards[0]._state.levels[0]) < 2  # debt drained
    assert g.level_sizes() == ref.level_sizes()
    assert sched.step()["decision"] == "idle"
    g.close()
    ref.close()


def test_scheduler_skips_hot_shard():
    g = _sharded_with_debt()
    sched = CompactionScheduler(g)
    # A writer commits on shard 0 between ticks: its ack histogram count
    # advances, so the only eligible shard is HOT and must be skipped.
    obs.histogram("shard_ack_seconds", shard="0").observe(0.001)
    out = sched.step()
    assert out["decision"] == "skip_hot"
    assert len(g.shards[0]._state.levels[0]) >= 2  # untouched
    # Next tick the shard is quiet again: compaction proceeds.
    assert sched.step()["decision"] == "compact"
    g.close()


def test_scheduler_backs_off_on_ack_latency_jump():
    g = _sharded_with_debt(n_runs=4)
    sched = CompactionScheduler(g, min_l0=1)
    h = obs.histogram("shard_ack_seconds", shard="1")   # shard 1: not the
    h.observe(0.001)                                    # compact target
    h.observe(0.001)
    assert sched.step()["decision"] == "compact"        # baseline window
    h.observe(0.5)                                      # 500x mean jump
    base = sched.base_interval
    out = sched.step()
    assert out["decision"] == "skip_backoff"
    assert out["interval"] == pytest.approx(base * sched.backoff)
    # Calm window: interval decays back toward base and work resumes.
    h.observe(0.001)
    out = sched.step()
    assert out["decision"] in ("compact", "idle")
    assert out["interval"] == pytest.approx(base)
    dec = obs.REGISTRY.find("compaction_sched_decision_total")
    assert {i.labels["decision"] for i in dec} >= {"compact",
                                                   "skip_backoff"}
    g.close()


def test_scheduler_thread_starts_and_stops():
    """``start()`` runs ticks on a daemon thread until ``stop()``; the
    thread compacts the indebted shard and ends within the join budget."""
    g = _sharded_with_debt()
    sched = CompactionScheduler(g, interval=0.01).start()
    deadline = time.monotonic() + 30
    while len(g.shards[0]._state.levels[0]) >= 2:
        assert time.monotonic() < deadline, "scheduler never compacted"
        time.sleep(0.01)
    sched.stop()
    assert sched._thread is None
    g.close()
