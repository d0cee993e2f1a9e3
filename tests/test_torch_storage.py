"""The port's durable storage engine held against the JAX package's.

WAL records, segment files (format v1 and v2) and manifest records written
by ``repro_torch.storage`` for the same batches and runs must be byte-equal
to those ``repro.storage`` writes; a store directory written by either
package must open in the other with equal reads; and every crash point of
``DurableStorage`` must recover to the reference's recovered reads.  The
rest are the reference's ``tests/test_storage.py`` cases run through the
port on the CPU (``device="cpu"``).  Tolerance: none — every compared value
is an integer, a bool, a byte string or a float32 property carried through
unchanged.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import storage as jstorage  # noqa: E402
from repro.storage import manifest as jmanifest  # noqa: E402
from repro.storage import segments as jsegments  # noqa: E402
from repro.storage import wal as jwal  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core.types import RunFile  # noqa: E402
from repro_torch.storage import (SimulatedCrash, open_store,  # noqa: E402
                                 read_segment, read_segment_header,
                                 write_segment)
from repro_torch.storage import segments as psegments  # noqa: E402
from repro_torch.storage.manifest import Manifest, _frame  # noqa: E402
from repro_torch.storage.wal import (WriteAheadLog,  # noqa: E402
                                     encode_edges, iter_file_records,
                                     scan_wal_dir)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def popen(root, cfg=None, **kw):
    return open_store(str(root), cfg, device="cpu", **kw)


def _edges(n=4000, vmax=700, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vmax, n).astype(np.int32),
            rng.integers(0, vmax, n).astype(np.int32))


def _wal_reference(root):
    """Fold the surviving WAL records: the live edge set they hold.  Call
    BEFORE reopening (replay prunes the WAL)."""
    recs, _, _ = scan_wal_dir(os.path.join(root, "wal"))
    live = set()
    for (_seq, src, dst, ts, marker, prop) in recs:
        for s, d, m in zip(src.tolist(), dst.tolist(), marker.tolist()):
            (live.discard if m else live.add)((s, d))
    return live


def _edge_set(store):
    with store.snapshot() as snap:
        return snap.edge_set()


def _np_eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def _all_reads(store):
    """Every vertex's (dst, prop) adjacency and the edge set at τ."""
    vmax = store.cfg.vmax
    with store.snapshot() as snap:
        nb = snap.neighbors_batch(np.arange(vmax), return_props=True)
        return ([(np.asarray(d), np.asarray(p)) for d, p in nb],
                snap.edge_set())


def _same_reads(a, b, what):
    (na, ea), (nb, eb) = a, b
    assert ea == eb, f"{what}: edge sets differ"
    for v, ((da, pa), (db, pb)) in enumerate(zip(na, nb)):
        _np_eq(da, db, f"{what}: neighbors({v})")
        _np_eq(pa, pb, f"{what}: props({v})")


def _same_runs(js, ps, what):
    """Run membership, headers and arrays (valid prefixes and pads) of a
    JAX store and a port store equal."""
    assert [[r.fid for r in lvl] for lvl in js.levels] == \
        [[r.fid for r in lvl] for lvl in ps.levels], what
    for fid, jr in js.runs_by_fid.items():
        pr = ps.runs_by_fid[fid]
        assert (jr.level, jr.min_vid, jr.max_vid, jr.nv, jr.ne) == \
            (pr.level, pr.min_vid, pr.max_vid, pr.nv, pr.ne)
        pa = convert.to_numpy(pr.ensure_loaded())
        ja = jr.ensure_loaded()
        for f in pa._fields:
            _np_eq(getattr(ja, f), getattr(pa, f), f"{what}: run {fid}.{f}")
        _np_eq(jr.presence.words, pr.presence.words, f"{what}: filter {fid}")


# --------------------------------------------------------------------- WAL
def _batch(i, n=100):
    src, dst = _edges(n, seed=i)
    ts = np.arange(i * n, (i + 1) * n, dtype=np.int32)
    marker = src % 7 == 0
    prop = np.random.default_rng(i).standard_normal(n).astype(np.float32)
    return src, dst, ts, marker, prop


def test_wal_record_bytes_equal_reference(tmp_path):
    """``encode_edges`` and the WAL files of both packages, byte for byte
    (abort records and rotation included)."""
    for i in range(3):
        assert encode_edges(*_batch(i)) == jwal.encode_edges(*_batch(i))
    files = {}
    for name, cls in (("port", WriteAheadLog), ("ref", jwal.WriteAheadLog)):
        wal = cls(str(tmp_path / name), sync="off")
        for i in range(3):
            wal.append_edges(*_batch(i))
        wal.append_abort(200)
        wal.rotate()
        wal.append_edges(*_batch(3))
        wal.close()
        files[name] = {f: open(tmp_path / name / f, "rb").read()
                       for f in sorted(os.listdir(tmp_path / name))}
    assert files["port"] == files["ref"] and len(files["port"]) == 2


def test_wal_roundtrip_and_torn_tail(tmp_path):
    wdir = str(tmp_path / "wal")
    wal = WriteAheadLog(wdir, sync="off")
    batches = [_batch(i) for i in range(5)]
    for b in batches:
        wal.append_edges(*b)
    wal.close()
    path = os.path.join(wdir, "wal-00000000.log")
    got = list(iter_file_records(path))
    assert len(got) == 5
    for g, b in zip(got, batches):
        for x, y in zip(g, b):
            np.testing.assert_array_equal(x, y)
    # Torn tail: truncate mid-record — replay keeps the valid prefix only.
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 37)
    assert len(list(iter_file_records(path))) == 4
    assert len(list(jwal.iter_file_records(path))) == 4


def test_wal_rotate_and_prune(tmp_path):
    wdir = str(tmp_path / "wal")
    wal = WriteAheadLog(wdir, sync="off")
    one = (np.asarray([False]), np.asarray([0.0], np.float32))
    wal.append_edges(np.asarray([1]), np.asarray([2]), np.asarray([0]), *one)
    wal.rotate()
    wal.append_edges(np.asarray([3]), np.asarray([4]), np.asarray([1]), *one)
    assert len(os.listdir(wdir)) == 2
    wal.prune(floor_ts=1)       # file 0 (last ts 0) is below the floor
    assert len(os.listdir(wdir)) == 1
    wal.prune(floor_ts=100)     # active file is never pruned
    assert len(os.listdir(wdir)) == 1
    wal.close()


def test_wal_abort_cancels_preceding_record(tmp_path):
    wdir = str(tmp_path / "wal")
    wal = WriteAheadLog(wdir, sync="off")
    for i in range(2):
        src, dst = _edges(10, seed=i)
        wal.append_edges(src, dst, np.arange(i * 10, (i + 1) * 10,
                                             dtype=np.int32),
                         np.zeros(10, bool), np.zeros(10, np.float32))
    wal.append_abort(10)  # cancels the second batch (ts_start == 10)
    wal.close()
    got = list(iter_file_records(os.path.join(wdir, "wal-00000000.log")))
    assert len(got) == 1 and int(got[0][2][0]) == 0


# ---------------------------------------------------------------- segments
@pytest.fixture(scope="module")
def store_pair():
    """One insert/delete stream through an in-memory store of each package
    (L0 and L1 runs): the runs both write to segment files."""
    from repro.core import LSMGraph as JaxGraph
    js, ps = JaxGraph(small_store_cfg()), LSMGraph(pcfg(), device="cpu")
    src, dst = _edges(3000)
    prop = np.arange(3000, dtype=np.float32) / 7
    for g in (js, ps):
        g.insert_edges(src, dst, prop=prop)
        g.delete_edges(src[:200], dst[:200])
        g.insert_edges(src[:300] + 1, dst[:300])
    _same_runs(js, ps, "in-memory stores")
    assert ps.levels[0] and ps.levels[1]
    return js, ps


@pytest.mark.parametrize("version", [1, 2])
def test_segment_files_byte_equal_reference(store_pair, tmp_path, version):
    """The same run gives the same segment file in both packages, and each
    package reads the other's file back to the same arrays."""
    js, ps = store_pair
    for fid, jr in js.runs_by_fid.items():
        pr = ps.runs_by_fid[fid]
        jp, pp = str(tmp_path / f"j{fid}.csr"), str(tmp_path / f"p{fid}.csr")
        n = write_segment(pp, pr, version=version)
        assert n == jsegments.write_segment(jp, jr, version=version)
        assert open(pp, "rb").read() == open(jp, "rb").read()
        meta, run = read_segment(jp, device="cpu")
        jmeta, jrun = jsegments.read_segment(pp)
        assert meta == jmeta and meta["ver"] == version
        run = convert.to_numpy(run)
        for f in run._fields:
            _np_eq(getattr(jrun, f), getattr(run, f), f"seg {fid}.{f}")
        filt = psegments.read_segment_filter(jp)
        if version == 1:
            assert filt is None
        else:
            _np_eq(filt.words, pr.presence.words, f"filter {fid}")


def test_segment_roundtrip(store_pair, tmp_path):
    _js, g = store_pair
    rf = g.levels[1][0]
    path = str(tmp_path / "seg.csr")
    nbytes = write_segment(path, rf)
    assert nbytes == os.path.getsize(path)
    meta = read_segment_header(path)
    assert (meta["fid"], meta["level"], meta["nv"], meta["ne"]) == \
        (rf.fid, rf.level, rf.nv, rf.ne)
    meta2, run = read_segment(path, device="cpu")
    assert meta2 == meta
    # An L1+ run's capacities are the load's own quantized ones: the whole
    # tensors, pads included, come back.
    for f in run._fields:
        assert torch.equal(getattr(rf.arrays, f), getattr(run, f)), f


def test_segment_corruption_detected(store_pair, tmp_path):
    _js, g = store_pair
    rf = g.levels[0][0]
    path = str(tmp_path / "seg.csr")
    write_segment(path, rf)
    with open(path, "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    with pytest.raises(ValueError, match="CRC"):
        read_segment(path, device="cpu")


def test_segment_roundtrip_property():
    """Hypothesis: serialize/deserialize is exact on the valid region for
    arbitrary edge batches (dup edges, tombstones, unsorted input), with a
    valid-prefix length that leaves the property column off 4-byte
    alignment as often as not."""
    pytest.importorskip("hypothesis")
    import tempfile

    from hypothesis import given, settings, strategies as st

    from repro_torch.core import csr

    @settings(max_examples=25, deadline=None)
    @given(st.data())
    def inner(data):
        n = data.draw(st.integers(1, 200))
        rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
        cap = csr.quantize_cap(n)

        def col(a):
            return torch.from_numpy(np.pad(a, (0, cap - n)))
        ts = np.sort(rng.integers(0, 1000, n)).astype(np.int32)
        run = csr.build_run_arrays(
            col(rng.integers(0, 50, n).astype(np.int32)),
            col(rng.integers(0, 50, n).astype(np.int32)), col(ts),
            col(rng.random(n) < 0.2),
            col(rng.standard_normal(n).astype(np.float32)), n, vcap=cap)
        nv, ne = int(run.nv), int(run.ne)
        vk = run.vkeys[:nv].numpy()
        rf = RunFile(fid=7, level=2, arrays=run,
                     min_vid=int(vk[0]) if nv else 0,
                     max_vid=int(vk[-1]) if nv else -1,
                     created_ts=int(ts[-1]), nv=nv, ne=ne)
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "seg.csr")
            write_segment(path, rf)
            _, back = read_segment(path, device="cpu")
        assert torch.equal(run.vkeys[:nv], back.vkeys[:nv])
        assert torch.equal(run.voff[:nv + 1], back.voff[:nv + 1])
        for f in ("dst", "ts", "marker", "prop"):
            assert torch.equal(getattr(run, f)[:ne], getattr(back, f)[:ne])

    inner()


# ---------------------------------------------------------------- manifest
def test_manifest_records_byte_equal_reference(tmp_path):
    recs = [{"op": "open", "format": 1,
             "config": dataclasses.asdict(pcfg())},
            {"op": "flush", "tau": 5, "wal_floor": 5, "next_fid": 1,
             "add": [{"fid": 0, "level": 0, "file": "seg-00000000.csr",
                      "min_vid": 0, "max_vid": 3, "created_ts": 5,
                      "nv": 2, "ne": 4, "wal_seq": 0}]},
            {"op": "compact", "tau": 9, "level": 1, "next_fid": 2,
             "remove": [0], "add": []}]
    for r in recs:
        assert _frame(r) == jmanifest._frame(r)
    for name, cls in (("p", Manifest), ("j", jmanifest.Manifest)):
        os.makedirs(tmp_path / name)
        m = cls(str(tmp_path / name))
        for r in recs:
            m.append(r)
        m.close()
    assert open(tmp_path / "p" / "MANIFEST.log", "rb").read() == \
        open(tmp_path / "j" / "MANIFEST.log", "rb").read()


def test_manifest_torn_tail_dropped(tmp_path):
    root = str(tmp_path)
    m = Manifest(root)
    m.append({"op": "open", "config": {"vmax": 8}})
    m.append({"op": "flush", "tau": 5, "wal_floor": 5, "next_fid": 1,
              "add": [{"fid": 0, "level": 0, "file": "seg-00000000.csr",
                       "min_vid": 0, "max_vid": 3, "created_ts": 5,
                       "nv": 2, "ne": 4}]})
    m.close()
    path = os.path.join(root, "MANIFEST.log")
    whole = Manifest.load_state(root)
    assert whole.segments and whole.wal_floor == 5
    # Torn last line (crash mid-append): the flush edit is dropped whole.
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 10)
    st = Manifest.load_state(root)
    assert st.n_records == 1 and not st.segments and st.wal_floor == 0
    # A corrupt (bit-flipped) line also stops replay.
    with open(path, "wb") as f:
        f.write(_frame({"op": "open", "config": {}}))
        bad = bytearray(_frame({"op": "flush", "tau": 9, "add": []}))
        bad[5] ^= 0xFF
        f.write(bytes(bad))
    assert Manifest.load_state(root).n_records == 1


# ---------------------------------------------------- durable write/reopen
def _stream(g, seed=3):
    src, dst = _edges(6000, seed=seed)
    g.insert_edges(src, dst, prop=np.arange(6000, dtype=np.float32))
    di = np.random.default_rng(0).choice(6000, 400, replace=False)
    g.delete_edges(src[di], dst[di])
    return src, dst, di


def test_reopen_matches_with_deletes_and_props(tmp_path):
    g = popen(tmp_path / "db", pcfg(), wal_sync="off")
    src, dst, di = _stream(g)
    ref = {}
    for i, (s, d) in enumerate(zip(src.tolist(), dst.tolist())):
        ref.setdefault(s, {})[d] = float(i)
    for i in di:
        ref[int(src[i])].pop(int(dst[i]), None)
    pre = _all_reads(g)
    assert g.level_sizes()[1] > 0  # compactions ran → manifest has edits
    g.close()

    g2 = popen(tmp_path / "db")  # config restored from the manifest
    _same_reads(pre, _all_reads(g2), "reopened")
    with g2.snapshot() as snap:
        for v in list(ref)[:25]:
            dsts, props = snap.neighbors(v, return_props=True)
            got = {int(d): float(p) for d, p in zip(dsts, props)}
            assert got == ref[v], v
    # the recovered store keeps ingesting + flushing durably
    g2.insert_edges([4000], [4001])
    assert g2.query_edge(4000, 4001)
    g2.close()


def test_disk_bytes_and_io_accounting_equal_reference(tmp_path):
    """The same stream through a durable store of each package: equal
    directory trees (every file byte-equal), disk bytes and I/O counters."""
    g = popen(tmp_path / "p", pcfg(), wal_sync="off")
    j = jstorage.open_store(str(tmp_path / "j"), small_store_cfg(),
                            wal_sync="off")
    src, dst = _edges(3000)
    for s in (g, j):
        s.insert_edges(src, dst)
    assert g.io.wal_write > 0 and g.io.segment_write > 0
    assert g.io.durable_write() == g.io.wal_write + g.io.segment_write
    real = g.disk_bytes()
    walked = sum(os.path.getsize(os.path.join(p, f))
                 for p, _, fs in os.walk(tmp_path / "p") for f in fs)
    assert real == walked > 0
    assert real == j.disk_bytes()
    assert g.io.as_dict() == dataclasses.asdict(j.io)
    _same_runs(j, g, "durable stores")
    for s in (g, j):
        s.close()
    for sub in ("segments", "wal", "."):
        names = sorted(os.listdir(tmp_path / "p" / sub))
        assert names == sorted(os.listdir(tmp_path / "j" / sub))
        for n in names:
            p, q = tmp_path / "p" / sub / n, tmp_path / "j" / sub / n
            if p.is_file():
                assert p.read_bytes() == q.read_bytes(), f"{sub}/{n}"
    # in-memory stores keep the proxy formula
    mem = LSMGraph(pcfg(), device="cpu")
    mem.insert_edges(src, dst)
    assert mem.disk_bytes() > 0 and mem.io.wal_write == 0


def test_manifest_append_after_torn_tail(tmp_path):
    """A crash-torn manifest tail is truncated at reopen: edits appended
    after it would otherwise sit behind the corrupt line."""
    root = tmp_path / "db"
    g = popen(root, pcfg(), wal_sync="off")
    src, dst = _edges(4000)
    g.insert_edges(src, dst)
    pre = _edge_set(g)
    g.close()
    with open(os.path.join(root, "MANIFEST.log"), "ab") as f:
        f.write(b'{"op":"flush","tau":9')  # torn mid-append by power loss
    g2 = popen(root)
    assert _edge_set(g2) == pre
    g2.insert_edges(src[:2000] + 1000, dst[:2000] + 1000)
    g2.flush_memgraph()  # appends fresh manifest edits + prunes WAL
    post = _edge_set(g2)
    g2.close()
    g3 = popen(root)  # the fresh edits must be visible, not shadowed
    assert _edge_set(g3) == post
    g3.close()


def test_crash_during_open_record(tmp_path):
    """An empty or torn "open" line does not brick the directory."""
    root = str(tmp_path / "db")
    os.makedirs(root)
    open(os.path.join(root, "MANIFEST.log"), "wb").close()  # empty = torn
    g = popen(root, pcfg(), wal_sync="off")
    g.insert_edges([1], [2])
    g.close()
    g2 = popen(root)
    assert g2.query_edge(1, 2)
    g2.close()


def test_evict_under_pinned_snapshot(tmp_path):
    """Evicting while a snapshot is pinned: reads reload transparently."""
    g = popen(tmp_path / "db", pcfg(), wal_sync="off")
    src, dst = _edges(6000)
    g.insert_edges(src, dst)
    with g.snapshot() as snap:
        pre = snap.edge_set()
        assert g.durability.evict_cold_segments() > 0
        assert snap.edge_set() == pre          # analytics-path reload
        v = int(src[0])
        _np_eq(snap.neighbors(v), snap.neighbors_scalar(v), "both paths")
    g.close()


def test_evict_and_lazy_reload(tmp_path):
    g = popen(tmp_path / "db", pcfg(), wal_sync="off")
    src, dst = _edges(6000)
    g.insert_edges(src, dst)
    pre = _edge_set(g)
    before = {rf.fid: rf.arrays for lvl in g.levels[1:] for rf in lvl}
    assert g.durability.evict_cold_segments() > 0
    assert all(r.arrays is None for r in g.levels[1])
    assert _edge_set(g) == pre          # snapshot reloads lazily
    assert g.io.segment_read > 0 and g.io.cold_load > 0
    for fid, a in before.items():       # byte-equal reload, pads included
        b = g.runs_by_fid[fid].arrays
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), (fid, f)
    g.close()


# ---------------------------------------------------------- crash recovery
def _crash_post_wal_append(g):
    src, dst = _edges(500)  # below the flush threshold: WAL-only state
    g.insert_edges(src, dst)


def _crash_flush_or_compact(g):
    src, dst = _edges(4000)
    with pytest.raises((SimulatedCrash, jstorage.SimulatedCrash)):
        g.insert_edges(src, dst)


@pytest.mark.parametrize("point", ["post_wal_append", "pre_manifest_flush",
                                   "pre_manifest_compact"])
def test_crash_points_recover_to_reference(tmp_path, point):
    """Each crash point of ``DurableStorage``, in both packages on the same
    stream: the port's recovered reads, run arrays and files equal the
    reference's recovered ones, and the edge set equals the pre-crash
    truth (the WAL fold where no segment was published)."""
    drive = (_crash_post_wal_append if point == "post_wal_append"
             else _crash_flush_or_compact)
    out = {}
    for name, opener, cfg in (
            ("p", popen, pcfg()),
            ("j", lambda r, c, **kw: jstorage.open_store(str(r), c, **kw),
             small_store_cfg())):
        root = str(tmp_path / name)
        g = opener(root, cfg, wal_sync="off")
        if point != "post_wal_append":
            g.durability.crash_at = {point}
        drive(g)
        pre = _edge_set(g)
        segs = set(os.listdir(os.path.join(root, "segments")))
        live = {d["file"] for d in Manifest.load_state(root).segments.values()}
        if point == "pre_manifest_flush":
            assert len(segs) == 1 and not live   # an orphan flush segment
            assert _wal_reference(root) == pre
        elif point == "pre_manifest_compact":
            assert segs > live                   # orphan merge outputs
        else:
            assert _wal_reference(root) == pre
        del g  # crash: no close
        g2 = opener(root, None) if name == "j" else popen(root)
        out[name] = (g2, pre, _all_reads(g2))
        assert out[name][2][1] == pre, f"{name}: recovered edge set"
        remaining = set(os.listdir(os.path.join(root, "segments")))
        assert remaining <= {d["file"] for d in
                             Manifest.load_state(root).segments.values()}
    _same_reads(out["j"][2], out["p"][2], f"recovered after {point}")
    _same_runs(out["j"][0], out["p"][0], f"recovered after {point}")
    for g2, _pre, _reads in out.values():
        g2.close()


def test_crash_during_recovery_replay(tmp_path):
    """Recovery itself is crash-safe: a crash right after recovery (replay
    flushes advanced the WAL floor) still recovers to the same state."""
    root = tmp_path / "db"
    g = popen(root, pcfg(), wal_sync="off")
    src, dst = _edges(4000)
    g.insert_edges(src, dst)
    pre = _edge_set(g)
    del g  # crash with a fat WAL tail
    g2 = popen(root)
    assert _edge_set(g2) == pre
    del g2  # crash again right after recovery
    g3 = popen(root)
    assert _edge_set(g3) == pre
    g3.close()


def test_recovery_resumes_tau_at_wal_floor(tmp_path):
    """τ resumes AT the durable WAL floor, not past it."""
    root = tmp_path / "db"
    g = popen(root, pcfg(), wal_sync="off")
    src, dst = _edges(4000)
    g.insert_edges(src, dst)
    g.flush_memgraph()  # drain: WAL tail empty, floor == τ
    floor = Manifest.load_state(str(root)).wal_floor
    assert g.tau == floor
    pre = _edge_set(g)
    g.close()
    g2 = popen(root)
    assert g2.tau == floor          # no inflation (e.g. from created_ts)
    assert _edge_set(g2) == pre
    g2.insert_edges([7], [4001])    # fresh ts allocation still unique
    assert g2.query_edge(7, 4001)
    g2.close()


def test_query_edges_batch_matches_scalar():
    g = LSMGraph(pcfg(), device="cpu")
    src, dst = _edges(4000, vmax=400)
    g.insert_edges(src, dst)
    g.delete_edges(src[:300], dst[:300])
    rng = np.random.default_rng(5)
    us = np.r_[src[:50], rng.integers(0, 400, 100).astype(np.int32)]
    vs = np.r_[dst[:50], rng.integers(0, 400, 100).astype(np.int32)]
    with g.snapshot() as snap:
        got = snap.query_edges_batch(us, vs)
        ref = np.array([int(v) in set(int(x) for x in snap.neighbors(int(u)))
                        for u, v in zip(us, vs)])
    np.testing.assert_array_equal(got, ref)
    live = np.flatnonzero(got)
    assert len(live)
    i = int(live[0])
    assert g.query_edge(int(us[i]), int(vs[i]))
    assert np.array_equal(g.query_edges_batch(us, vs), got)


# ------------------------------------------------- directories across packages
def _layered(g, seed):
    """A stream that leaves L0, L1 and L2 runs live with disjoint vertex
    ranges between L1 and L2 (so the reference's recovery keeps its index
    whole), a tombstone or two, and a MemGraph tail in the WAL."""
    rng = np.random.default_rng(seed)

    def ins(lo, hi, n):
        s = rng.integers(lo, hi, n).astype(np.int32)
        d = rng.integers(0, 4000, n).astype(np.int32)
        g.insert_edges(s, d, prop=rng.random(n).astype(np.float32))
        return s, d
    ins(0, 1000, 1500)
    g.flush_memgraph()
    g.compact_l0()
    g.compact_partial(1)                    # L2 holds [0, 1000)
    s, d = ins(2000, 3000, 1500)
    g.delete_edges(s[:50], d[:50])
    g.flush_memgraph()
    g.compact_l0()                          # L1 holds [2000, 3000)
    ins(3000, 4000, 700)
    g.flush_memgraph()                      # one L0 run
    ins(0, 4000, 300)                       # the WAL tail
    levels = [len(lvl) for lvl in g.levels]
    assert levels[0] and levels[1] and levels[2] and int(g.mem.ne) > 0, levels
    l1 = [(r.min_vid, r.max_vid) for r in g.levels[1]]
    l2 = [(r.min_vid, r.max_vid) for r in g.levels[2]]
    assert all(hi1 < lo2 or hi2 < lo1
               for lo1, hi1 in l1 for lo2, hi2 in l2)


def _index_np(store):
    return convert.to_numpy(store.index) if isinstance(
        store, LSMGraph) else store.index


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_opens_in_the_other_package(tmp_path, writer):
    """A directory written (and closed with a WAL tail) by one package
    opens in the other: equal reads, runs and level sizes, and the port's
    recovered index equals the index the writing store held."""
    from repro.core import LSMGraph as JaxGraph
    root = str(tmp_path / "db")
    if writer == "reference":
        w = jstorage.open_store(root, small_store_cfg(), wal_sync="off")
    else:
        w = popen(root, pcfg(), wal_sync="off")
    _layered(w, seed=9)
    pre = _all_reads(w)
    pre_index = _index_np(w)
    w.close()
    if writer == "reference":
        other = popen(root)
        assert isinstance(other, LSMGraph)
    else:
        other = jstorage.open_store(root)
        assert isinstance(other, JaxGraph)
    _same_reads(pre, _all_reads(other), f"{writer}-written, reopened")
    if writer == "reference":
        # The reference's live index leaves an offset behind where it
        # clears a vertex's file id; offsets count only under a file id.
        got = _index_np(other)
        for f in ("l0_first_fid", "l0_min_fid", "lvl_fid"):
            _np_eq(getattr(pre_index, f), getattr(got, f),
                   f"recovered index.{f}")
        named = pre_index.lvl_fid != np.iinfo(np.int32).max
        _np_eq(np.where(named, pre_index.lvl_off, 0),
               np.where(named, got.lvl_off, 0), "recovered index.lvl_off")
    other.close()


def test_recovery_keeps_l1_entries_under_l2_run(tmp_path):
    """The reference's recovery loses live L1 runs' index entries under an
    L2 run (ROADMAP, faults of the reference, 4): the smallest input, in
    both packages.  The port's reopened reads and IndexState equal its
    pre-close ones; the reference's reopened read drops (1, 20)."""
    out = {}
    for name in ("port", "ref"):
        root = str(tmp_path / name)
        if name == "port":
            g = popen(root, pcfg(l0_run_limit=1, seg_target_edges=4),
                      wal_sync="off")
        else:
            g = jstorage.open_store(
                root, small_store_cfg(l0_run_limit=1, seg_target_edges=4),
                wal_sync="off")
        g.insert_edges([1, 1, 5, 5], [10, 11, 10, 11])
        g.flush_memgraph()
        g.compact_l0()
        g.compact_partial(1)
        assert [len(lvl) for lvl in g.levels] == [0, 0, 1, 0, 0]
        g.insert_edges([1, 5], [20, 20])
        g.flush_memgraph()
        g.compact_l0()
        assert [len(lvl) for lvl in g.levels] == [0, 1, 1, 0, 0]
        with g.snapshot() as snap:
            before = [list(map(int, snap.neighbors(v))) for v in (1, 5)]
        index = _index_np(g)
        g.close()
        g2 = popen(root) if name == "port" else jstorage.open_store(root)
        with g2.snapshot() as snap:
            after = [list(map(int, snap.neighbors(v))) for v in (1, 5)]
        out[name] = (before, after, index, _index_np(g2))
        g2.close()
    before, after, index, index2 = out["port"]
    assert before == after == [[10, 11, 20], [10, 11, 20]]
    for f in index._fields:
        _np_eq(getattr(index, f), getattr(index2, f), f"index.{f}")
    assert out["ref"][0] == before
    assert out["ref"][1] == [[10, 11], [10, 11]]


# ------------------------------------------------------- subprocess SIGKILL
@pytest.mark.slow
def test_sigkill_recovery(tmp_path):
    """SIGKILL the ingesting child at an arbitrary moment; every batch it
    acked (insert + WAL fsync) must survive recovery."""
    from repro_torch.storage.crashtest import batch_edges, small_cfg

    root = str(tmp_path / "db")
    env = dict(os.environ)
    env["PYTHONPATH"] = "src" + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.storage.crashtest",
         "--dir", root, "--batch", "64", "--seed", "11", "--device", "cpu"],
        stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    acked = -1
    deadline = time.time() + 180
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("acked "):
                acked = int(line.split()[1])
            if acked >= 40:  # past several flushes + at least one compaction
                break
        if acked >= 0:
            # single-writer exclusion: the child holds the LOCK file
            with pytest.raises(RuntimeError, match="locked"):
                popen(root)
        proc.kill()  # SIGKILL: no atexit, no flush, no close
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert acked >= 5, "child never made progress"

    g = popen(root)
    got = _edge_set(g)
    must = set()
    for i in range(acked + 1):
        s, d = batch_edges(11, i, 64, small_cfg().vmax)
        must.update(zip(s.tolist(), d.tolist()))
    missing = must - got
    assert not missing, f"lost {len(missing)} acked edges"
    g.close()
