"""The port's other read paths held against the JAX package's: the
per-run batched lookup (``run_lookup_batch``, with the bisection kernel's
plain version), and the batched read on the read spine of a deep store,
with the no-index ablation of paper Fig 16, with the presence filters on
and off (``LSMG_READ_FILTERS``), and through several chunked resolves.

The same stream goes through ``repro.core.LSMGraph`` and
``repro_torch.core.LSMGraph(device="cpu")``; every read must be byte-equal
between the packages (adjacency and props), equal to the scalar read, and
leave equal I/O counters.  Tolerance: none (integers, bools and float32
props carried through unchanged).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import small_store_cfg  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro.core import StoreConfig as JaxConfig  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core import csr  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _pair(**kw):
    kw = dataclasses.asdict(small_store_cfg(**kw))
    return JaxGraph(JaxConfig(**kw)), LSMGraph(StoreConfig(**kw),
                                                device="cpu")


def _multi_tier_stores(seed):
    """``tests/test_read_batch.py``'s store in both packages: MemGraph, L0
    and L1 populated, with tombstones."""
    stores = _pair(l0_run_limit=100)
    for g in stores:
        rng = np.random.default_rng(seed)
        src = rng.integers(0, 500, 6000).astype(np.int32)
        dst = rng.integers(0, 500, 6000).astype(np.int32)
        g.insert_edges(src, dst, prop=np.arange(6000, dtype=np.float32))
        di = rng.choice(6000, 400, replace=False)
        g.delete_edges(src[di], dst[di])
        g.flush_memgraph()
        g.compact_l0()
        g.insert_edges(rng.integers(0, 500, 700), rng.integers(0, 500, 700))
        g.flush_memgraph()
        g.insert_edges(rng.integers(0, 500, 150), rng.integers(0, 500, 150))
        assert int(g.mem.ne) > 0 and g.levels[0] and g.levels[1]
    return stores


def _deep_stores(n_runs, seed):
    """``tests/test_read_pipeline.py``'s deep store in both packages: n_runs
    L0 runs and an active MemGraph."""
    stores = _pair(l0_run_limit=n_runs + 64)
    for g in stores:
        rng = np.random.default_rng(seed)
        for _ in range(n_runs):
            g.insert_edges(rng.integers(0, 400, 400),
                           rng.integers(0, 400, 400))
            g.flush_memgraph()
        g.insert_edges(rng.integers(0, 400, 200), rng.integers(0, 400, 200))
        assert len(g.levels[0]) == n_runs
    return stores


def _reads(stores, vs, *, index=True, chunk=None):
    """neighbors_batch (with props) of vs in both packages, held equal,
    and the scalar reads of the first 40 queries, held equal to them."""
    out, scalar = [], []
    for g in stores:
        snap = g.snapshot()
        try:
            object.__setattr__(snap.cfg, "use_multilevel_index", index)
            if chunk is not None:
                snap._BATCH_CHUNK = chunk     # instance override
            out.append(snap.neighbors_batch(vs, return_props=True))
            scalar.append([snap.neighbors_scalar(int(v)) for v in vs[:40]])
        finally:
            object.__setattr__(snap.cfg, "use_multilevel_index", True)
            snap.release()
    jax_out, port_out = out
    assert len(jax_out) == len(port_out) == len(vs)
    for v, (jd, jp), (pd, pp) in zip(vs, jax_out, port_out):
        for a, b in ((jd, pd), (jp, pp)):
            assert a.dtype == b.dtype and np.array_equal(a, b), f"vertex {v}"
    for (pd, _pp), js, ps in zip(port_out, *scalar):
        np.testing.assert_array_equal(pd, js)
        np.testing.assert_array_equal(pd, ps)
    return port_out


def _same(a, b):
    for (ad, ap), (bd, bp) in zip(a, b):
        np.testing.assert_array_equal(ad, bd)
        np.testing.assert_array_equal(ap, bp)


def _same_io(stores):
    js, ps = stores
    assert dataclasses.asdict(js.io) == ps.io.as_dict()


# ------------------------------------------------------- run_lookup_batch
def _lookup_run(kind):
    rng = np.random.default_rng(9)
    n = 500 if kind == "dense" else 0
    src = np.sort(rng.integers(0, 100, 500)).astype(np.int32)
    return jcsr.build_run_arrays(
        jnp.asarray(src), jnp.asarray(rng.integers(0, 100, 500), jnp.int32),
        jnp.asarray(np.arange(500), jnp.int32), jnp.zeros(500, bool),
        jnp.zeros(500, jnp.float32), jnp.asarray(n, jnp.int32), vcap=256)


@pytest.mark.parametrize("kind", ["dense", "empty"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_run_lookup_batch_matches_jax(kind, use_pallas):
    """``tests/test_read_batch.py``'s per-run lookup, on a run and on an
    empty run (nv = 0), carried across with ``convert``: (found, start,
    end) byte-equal to the JAX package's and to the scalar lookup.  A pad
    query (INVALID_VID) reports not-found."""
    jrun = _lookup_run(kind)
    prun = convert.csr_run_to_torch(jrun, "cpu")
    assert (int(prun.nv) == 0) == (kind == "empty")
    qs = np.r_[np.arange(-3, 110), [np.iinfo(np.int32).max]].astype(np.int32)
    want = [np.asarray(x) for x in jcsr.run_lookup_batch(
        jrun, jnp.asarray(qs), use_pallas=use_pallas)]
    ops.reset_launches()
    got = [x.numpy() for x in csr.run_lookup_batch(
        prun, torch.from_numpy(qs), use_pallas=use_pallas)]
    assert ops.launch_counts()["batched_searchsorted"] == 0   # CPU tensors
    for w, g, name in zip(want, got, ("found", "start", "end")):
        assert w.dtype == g.dtype and np.array_equal(w, g), name
    assert not got[0][-1]
    for i, v in enumerate(qs[:-1]):
        f, s, e = csr.run_lookup(prun, int(v))
        assert (bool(f), int(s), int(e)) == (bool(got[0][i]),
                                             int(got[1][i]), int(got[2][i]))


def _level_stores():
    """``tests/test_torch_multilevel.py``'s stream in both packages: five
    flushed parts over 300 vertices with a partial compaction after the
    third and deletes along the way, so the snapshot holds L0, L1 and L2
    runs."""
    rng = np.random.default_rng(5)
    key = np.unique(rng.integers(0, 300 * 300, 2400))
    rng.shuffle(key)
    u, w = key // 300, key % 300
    stores = _pair(vmax=300, l0_run_limit=2, seg_target_edges=256)
    parts = np.array_split(np.arange(len(u)), 6)
    for g in stores:
        for i, p in enumerate(parts[:5]):
            g.insert_edges(u[p], w[p])
            if i:
                gone = parts[i - 1][:60]
                g.delete_edges(u[gone], w[gone])
            g.flush_memgraph()
            if i == 2:
                g.compact_partial(1)
    return stores


def _runs_of(snap):
    return [rf.ensure_loaded() for rf in snap.l0_runs] + [
        rf.ensure_loaded() for lvl in snap.level_runs for rf in lvl]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_runs_lookup_batch_matches_jax_per_run(use_pallas):
    """``csr.runs_lookup_batch`` (every run in one multi-run search) on a
    store with L0, L1 and L2 runs: row r of (found, start, end) byte-equal
    to the JAX package's ``run_lookup_batch`` on run r (its Pallas search
    in interpret mode, and its plain search), and to the port's own
    per-run lookup.  Queries: every vertex, absent ones, INVALID_VID and
    INT32_MIN, 303 in all (not a multiple of 32)."""
    jg, pg = _level_stores()
    js, ps = jg.snapshot(), pg.snapshot()
    try:
        assert ps.l0_runs and len(ps.level_runs) > 1 and all(
            ps.level_runs[:2])
        jruns, pruns = _runs_of(js), _runs_of(ps)
        assert len(jruns) == len(pruns) > 3
        qs = np.r_[np.arange(-1, 300), [np.iinfo(np.int32).max,
                                        np.iinfo(np.int32).min]
                   ].astype(np.int32)
        ops.reset_launches()
        got = [x.numpy() for x in csr.runs_lookup_batch(
            pruns, torch.from_numpy(qs), use_pallas=use_pallas)]
        assert ops.launch_counts()["batched_searchsorted_runs"] == 0
        for r, (jrun, prun) in enumerate(zip(jruns, pruns)):
            want = [np.asarray(x) for x in jcsr.run_lookup_batch(
                jrun, jnp.asarray(qs), use_pallas=use_pallas)]
            own = csr.run_lookup_batch(prun, torch.from_numpy(qs),
                                       use_pallas=True)
            for w, g, o, name in zip(want, got, own,
                                     ("found", "start", "end")):
                assert w.dtype == g.dtype, name
                np.testing.assert_array_equal(g[r], w, err_msg=name)
                np.testing.assert_array_equal(g[r], o.numpy(), err_msg=name)
        assert got[0].any() and not got[0][:, -2:].any()
    finally:
        js.release()
        ps.release()


# ------------------------------------------------------------- read paths
def test_no_index_batch_equals_scalar_matches_jax():
    """``test_read_batch.py::test_batched_no_index_ablation``: the read
    spine with the multi-level index off (every run probed) equals the
    scalar read and the JAX package's, and the read with the index on."""
    stores = _multi_tier_stores(seed=4)
    vs = np.arange(0, 500, 3)
    off = _reads(stores, vs, index=False)
    _same(off, _reads(stores, vs))
    _same_io(stores)


@pytest.mark.parametrize("filters_on", ["1", "0"])
def test_deep_store_spine_read_matches_jax(monkeypatch, filters_on):
    """``test_read_pipeline.py``'s deep store (four L0 runs and an active
    MemGraph): the spine read equals the JAX package's and the scalar
    read, presence filters on and off, and leaves equal I/O counters."""
    monkeypatch.setenv("LSMG_READ_FILTERS", filters_on)
    stores = _deep_stores(4, seed=19)
    _reads(stores, np.arange(0, 410, 2))
    _same_io(stores)


@pytest.mark.parametrize("filters_on", ["1", "0"])
def test_spine_no_index_read_matches_jax(monkeypatch, filters_on):
    """The spine read with the index off (paper Fig 16 baseline: every run
    probed, past its filter) equals the read with it on, the JAX
    package's and the scalar read, presence filters on and off."""
    monkeypatch.setenv("LSMG_READ_FILTERS", filters_on)
    stores = _multi_tier_stores(seed=6)
    vs = np.arange(0, 520, 2)
    _same(_reads(stores, vs, index=False), _reads(stores, vs))
    _same_io(stores)


def test_spine_chunked_matches_jax():
    """The spine read through ``_resolve_batch_chunked`` (queries above
    the chunk bound stream through several resolves, here 9): the
    stitched result equals the one-shot read."""
    stores = _multi_tier_stores(seed=10)
    vs = np.arange(0, 520)
    one_shot = _reads(stores, vs)
    before = stores[1]._obs_resolve.count
    _same(_reads(stores, vs, chunk=64), one_shot)
    assert stores[1]._obs_resolve.count - before == 9
    _same_io(stores)
