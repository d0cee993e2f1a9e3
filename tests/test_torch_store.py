"""The port's in-memory store held against the JAX package's, end to end.

The same insert/delete sequence goes through ``repro.core.LSMGraph`` and
``repro_torch.core.LSMGraph(device="cpu")``.  After every operation the two
stores must agree byte for byte on τ, level sizes, fids per level, every
run's arrays and filter words, the MemGraph, the multi-level index and the
I/O counters; the sequence reaches L0 flushes, whole-L0 compaction and
partial compaction into L2.  At the end every read (batched, scalar, edge
membership, edge set) must be byte-equal between the packages and equal to
a numpy last-writer-wins oracle, with the presence filters on and off.
Tolerance: none — every compared value is an integer, a bool, or a float32
property carried through unchanged.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro.core import StoreConfig as JaxConfig  # noqa: E402
from repro.core import store as jax_store  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core import store as port_store  # noqa: E402

QUICKSTART = dict(vmax=1000, mem_edges=1 << 10, seg_size=4,
                  n_segments=1 << 10, hash_slots=1 << 11, ovf_cap=1 << 11,
                  batch_cap=256, l0_run_limit=2, seg_target_edges=1 << 12)


def _configs(name):
    if name == "small":
        kw = dataclasses.asdict(small_store_cfg())
    else:
        kw = dict(QUICKSTART)
    return JaxConfig(**kw), StoreConfig(**kw)


def _ops(vmax, seed):
    """Quickstart-style stream: a ring, random chords, deletes of chords,
    and two explicit partial compactions of L1 into L2; weighted props.
    Every directed edge is inserted at most once (deletes may repeat): the
    reference's compaction GC is exact only for such histories (see
    ``test_duplicate_insert_gc_matches_reference``)."""
    rng = np.random.default_rng(seed)
    n = min(vmax, 600)
    ring = np.arange(n)
    seen = set()

    def fresh(s, d):
        keep = []
        for i, (a, b) in enumerate(zip(s.tolist(), d.tolist())):
            if (a, b) not in seen:
                seen.add((a, b))
                keep.append(i)
        return s[keep], d[keep]

    s, d = fresh(np.r_[ring, (ring + 1) % n], np.r_[(ring + 1) % n, ring])
    ops = [("ins", s, d, np.ones(len(s), np.float32))]
    chords = []
    for k, m in enumerate((500, 500, 400, 300)):
        u = rng.integers(0, vmax, m)
        w = rng.integers(0, vmax, m)
        s, d = fresh(np.r_[u, w], np.r_[w, u])
        chords.append((s, d))
        ops.append(("ins", s, d, rng.random(len(s)).astype(np.float32)))
        cs = np.concatenate([c[0] for c in chords])
        cd = np.concatenate([c[1] for c in chords])
        pick = rng.integers(0, len(cs), 120)
        ops.append(("del", cs[pick], cd[pick], None))
        if k in (1, 3):
            ops.append(("compact", 1, None, None))
    return ops


def _apply(store, op):
    kind, s, d, p = op
    if kind == "ins":
        store.insert_edges(s, d, prop=p)
    elif kind == "del":
        store.delete_edges(s, d)
    else:
        store.compact_partial(s)


def _np_eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        f"{what}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def _same_io(js, ps, extra_read=0):
    """I/O counters equal, less ``extra_read`` analytics bytes of reads made
    on the port store alone."""
    pio = ps.io.as_dict()
    pio["analytics_read"] -= extra_read
    assert dataclasses.asdict(js.io) == pio


def assert_same_state(js, ps, extra_read=0):
    assert js.tau == ps.tau
    assert js.level_sizes() == ps.level_sizes()
    assert [[r.fid for r in lvl] for lvl in js.levels] == \
        [[r.fid for r in lvl] for lvl in ps.levels]
    assert sorted(js.runs_by_fid) == sorted(ps.runs_by_fid)
    for fid, jr in js.runs_by_fid.items():
        pr = ps.runs_by_fid[fid]
        assert (jr.level, jr.min_vid, jr.max_vid, jr.nv, jr.ne) == \
            (pr.level, pr.min_vid, pr.max_vid, pr.nv, pr.ne)
        pa = convert.to_numpy(pr.arrays)
        for f in pa._fields:
            _np_eq(getattr(jr.arrays, f), getattr(pa, f), f"run {fid}.{f}")
        _np_eq(jr.presence.words, pr.presence.words, f"run {fid} filter")
        assert jr.presence.mbits == pr.presence.mbits
    pi = convert.to_numpy(ps.index)
    for f in pi._fields:
        _np_eq(getattr(js.index, f), getattr(pi, f), f"index.{f}")
    pm = convert.to_numpy(ps.mem)
    for f in pm._fields:
        _np_eq(getattr(js.mem, f), getattr(pm, f), f"mem.{f}")
    _same_io(js, ps, extra_read)


def _oracle(ops, queries):
    """numpy last-writer-wins adjacency of every queried source."""
    ops = [o for o in ops if o[0] != "compact"]
    src = np.concatenate([o[1] for o in ops]).astype(np.int64)
    dst = np.concatenate([o[2] for o in ops]).astype(np.int64)
    ins = np.concatenate([np.full(len(o[1]), o[0] == "ins") for o in ops])
    out = {}
    for v in queries:
        m = np.nonzero(src == v)[0]
        last = {}
        for i in m:
            last[int(dst[i])] = bool(ins[i])
        out[int(v)] = np.array(sorted(k for k, live in last.items() if live),
                               np.int64)
    return out


@pytest.fixture(scope="module", params=["small", "quickstart"])
def stores(request):
    jcfg, pcfg = _configs(request.param)
    js, ps = JaxGraph(jcfg), LSMGraph(pcfg, device="cpu")
    ops = _ops(pcfg.vmax, seed=1)
    seen = set()
    probe = np.arange(0, pcfg.vmax, 5)
    stats0 = port_store._MERGE_STATS.snapshot_stats()
    extra = 0
    for k, op in enumerate(ops):
        _apply(js, op)
        _apply(ps, op)
        assert_same_state(js, ps, extra)
        seen.update(i for i, lvl in enumerate(ps.levels) if lvl)
        if k % 2:
            # Reads between commits: each sealed epoch's spine is spliced
            # from the cached one, not rebuilt; a second snapshot at the
            # same epoch shares the state's spine.
            want = _oracle(ops[:k + 1], probe)
            before = ps.io.analytics_read
            for _ in range(2):
                with ps.snapshot() as snap:
                    for v, got in zip(probe, snap.neighbors_batch(probe)):
                        _np_eq(want[int(v)], got, f"read after op {k}")
            extra += ps.io.analytics_read - before
    stats = {k: v - stats0[k]
             for k, v in port_store._MERGE_STATS.snapshot_stats().items()}
    assert stats["spine_build"] >= 1 and stats["spine_splice"] >= 1
    assert stats["kernel_merge"] >= 1
    # An active MemGraph at read time (no flush: a few edges only).
    tail = ("ins", np.array([0, 1, 2, 3]), np.array([500, 501, 502, 503]),
            np.full(4, 2.5, np.float32))
    _apply(js, tail)
    _apply(ps, tail)
    ops.append(tail)
    assert_same_state(js, ps, extra)
    return js, ps, ops, seen, extra


def test_sequence_reaches_l2(stores):
    js, ps, _ops_, seen, _extra = stores
    assert {0, 1, 2} <= seen
    assert ps.levels[2], "partial compaction into L2 did not happen"
    assert int(ps.mem.ne) > 0


@pytest.mark.parametrize("filters_on", ["1", "0"])
def test_reads_equal(stores, filters_on, monkeypatch):
    monkeypatch.setenv("LSMG_READ_FILTERS", filters_on)
    js, ps, ops, _seen, extra = stores
    vmax = ps.cfg.vmax
    every = np.arange(vmax)
    oracle = _oracle(ops, every)
    with js.snapshot() as jsnap, ps.snapshot() as psnap:
        jn = jsnap.neighbors_batch(every, return_props=True)
        pn = psnap.neighbors_batch(every, return_props=True)
        for v in range(vmax):
            _np_eq(jn[v][0], pn[v][0], f"neighbors({v})")
            _np_eq(jn[v][1], pn[v][1], f"props({v})")
            _np_eq(oracle[v], pn[v][0], f"oracle({v})")
        for v in range(0, vmax, 97):
            one = psnap.neighbors_scalar(v)
            _np_eq(jsnap.neighbors_scalar(v), one, f"neighbors_scalar({v})")
            _np_eq(one, pn[v][0], f"scalar vs batch {v}")
        rng = np.random.default_rng(5)
        us = rng.integers(0, vmax, 400)
        ws = np.r_[rng.integers(0, vmax, 200),
                   [int(pn[u][0][0]) if len(pn[u][0]) else 0
                    for u in us[200:]]]
        _np_eq(jsnap.query_edges_batch(us, ws),
               psnap.query_edges_batch(us, ws), "query_edges_batch")
        assert jsnap.edge_set() == psnap.edge_set()
        _np_eq(jsnap.vertices(), psnap.vertices(), "vertices")
        _np_eq(jsnap.degrees_batch(every[:50]), psnap.degrees_batch(every[:50]),
               "degrees_batch")
        assert jsnap.degree(3) == psnap.degree(3) == len(oracle[3])
    _same_io(js, ps, extra)


def test_reference_runs_through_port_read_path(stores):
    """Runs the reference built, carried into the port by ``convert``: the
    port's merge_runs, spine build and backbone resolve give the
    reference's outputs byte for byte."""
    js = stores[0]
    from repro.core import csr as jcsr
    from repro.core.types import RunFile as JaxRunFile
    from repro_torch.core import csr as pcsr
    from repro_torch.core.types import RunFile
    arrays = [r.arrays for lvl in js.levels for r in lvl]
    big = max(arrays, key=lambda a: int(a.ne))
    third = js.cfg.vmax // 3
    arrays += [jcsr.run_slice_vertex_range(big, lo, lo + third,
                                           vcap=big.vcap)
               for lo in (0, third)]
    p_arrays = [convert.csr_run_to_torch(a, "cpu") for a in arrays]
    tot = sum(int(a.ne) for a in arrays)
    vcap = jcsr.quantize_cap(tot)
    jm = jcsr.merge_runs(arrays, js.tau, vcap=vcap)
    pm = convert.to_numpy(pcsr.merge_runs(p_arrays, js.tau, vcap=vcap))
    for f in pm._fields:
        _np_eq(getattr(jm, f), getattr(pm, f), f"merge_runs.{f}")

    def wrap(cls, i, a):
        return cls(fid=i, level=0, arrays=a, min_vid=0, max_vid=0,
                   created_ts=0, nv=int(a.nv), ne=int(a.ne))
    jspine = jax_store._build_run_spine(
        [(wrap(JaxRunFile, i, a), -1) for i, a in enumerate(arrays)])
    pspine = port_store._build_run_spine(
        [(wrap(RunFile, i, a), -1) for i, a in enumerate(p_arrays)], "cpu")
    assert len(arrays) >= 3
    for i, (jc, pc) in enumerate(zip(jspine.cols, pspine.cols)):
        _np_eq(jc, pc.numpy(), f"spine col {i}")

    u = np.arange(0, js.cfg.vmax, 3).astype(np.int32)
    bp = jcsr.quantize_cap(len(u), minimum=64)
    u_pad = np.full(bp, np.iinfo(np.int32).max, np.int32)
    u_pad[:len(u)] = u
    vis = np.random.default_rng(2).random((len(arrays), bp)) < 0.8
    jq, jl, jn = jax_store._backbone_resolve(
        *jspine.cols[:5], u_pad, vis, js.tau, len(u))
    c = [convert.array_to_torch(np.asarray(x), "cpu")
         for x in jspine.cols[:5]]
    pq, pl, pn = port_store._backbone_resolve(
        *c, torch.from_numpy(u_pad), torch.from_numpy(vis), js.tau, len(u))
    _np_eq(jq, pq.numpy(), "backbone qid")
    _np_eq(jl, pl.numpy(), "backbone live")
    assert int(jn) == int(pn)
