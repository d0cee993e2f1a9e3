"""The port's core modules against the JAX package's, module by module.

CSR runs (build, lookup, merge with version GC, slicing, padding), the
MemGraph (insert in all three modes with the hashmap claim rounds forced by
a small table, flush, scans), the multi-level index (including the folded
per-commit update) and the filter builder.  Inputs come from numpy seeds
and go through both packages; ``repro_torch.convert`` carries states
across.  Tolerance: none — every output is an integer, bool or float32
array carried through unchanged, and must be byte-equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from conftest import small_store_cfg  # noqa: E402
from repro.core import csr as jcsr  # noqa: E402
from repro.core import index as jindex  # noqa: E402
from repro.core import memgraph as jmg  # noqa: E402
from repro.core.types import EdgeBatch as JaxEdgeBatch  # noqa: E402
from repro.core.types import StoreConfig as JaxConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import csr, index, memgraph  # noqa: E402
from repro_torch.core.types import StoreConfig  # noqa: E402

I32MAX = np.iinfo(np.int32).max


def _eq(want, got, what=""):
    """Byte-equality of a JAX-side value and a port-side value (tensor,
    NamedTuple of tensors, or tuple)."""
    if isinstance(got, torch.Tensor):
        w, g = np.asarray(want), got.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, \
            f"{what}: {w.dtype}{w.shape} vs {g.dtype}{g.shape}"
        np.testing.assert_array_equal(g, w, err_msg=what)
        return
    fields = getattr(got, "_fields", None)
    names = fields or range(len(got))
    for i, name in enumerate(names):
        _eq(want[i], got[i], f"{what}.{name}")


def _raw(rng, n, cap, vmax=40, dup=True):
    """Raw edge columns (padded to cap) with repeated keys and tombstones."""
    src = rng.integers(0, vmax, n).astype(np.int32)
    dst = rng.integers(0, vmax if dup else 10 * vmax, n).astype(np.int32)
    ts = rng.permutation(10 * n + 1)[:n].astype(np.int32)
    marker = rng.random(n) < 0.3
    prop = rng.random(n).astype(np.float32)

    def pad(a):
        out = np.zeros(cap, a.dtype)
        out[:n] = a
        return out
    return tuple(pad(a) for a in (src, dst, ts, marker, prop))


def _both(cols):
    return ([jnp.asarray(c) for c in cols],
            [torch.from_numpy(c.copy()) for c in cols])


# ---------------------------------------------------------------------- csr
@pytest.mark.parametrize("n,cap,vcap", [(0, 64, 32), (4, 64, 32),
                                        (200, 256, 256), (300, 512, 64)])
def test_build_run_arrays(n, cap, vcap):
    rng = np.random.default_rng(n + cap)
    j, p = _both(_raw(rng, n, cap))
    want = jcsr.build_run_arrays(*j, jnp.asarray(n, jnp.int32), vcap=vcap)
    got = csr.build_run_arrays(*p, n, vcap=vcap)
    _eq(want, got, "run")
    _eq(jcsr._expand_src(want), csr.expand_src(got), "expand_src")


def _mk_pair(rng, n=120, cap=128):
    j, p = _both(_raw(rng, n, cap, vmax=30))
    jr = jcsr.build_run_arrays(*j, jnp.asarray(n, jnp.int32), vcap=64)
    return jr, convert.csr_run_to_torch(jr, "cpu")


def test_run_lookups_and_slices():
    rng = np.random.default_rng(7)
    jr, pr = _mk_pair(rng)
    for v in (0, 3, 17, 29, 31, 1000):
        _eq(jcsr.run_lookup(jr, jnp.asarray(v, jnp.int32)),
            csr.run_lookup(pr, v), f"run_lookup({v})")
    for start, end in ((0, 5), (10, 40), (100, 140), (3, 3)):
        _eq(jcsr.run_gather(jr, jnp.asarray(start), jnp.asarray(end), cap=16),
            csr.run_gather(pr, start, end, cap=16), f"gather[{start}:{end}]")
    _eq(jcsr.run_slice_vertex_range(jr, 5, 20, vcap=32),
        csr.run_slice_vertex_range(pr, 5, 20, vcap=32), "slice")
    for vc, ec in ((32, 64), (128, 256), (64, 128)):
        _eq(jcsr.repad_run(jr, vc, ec), csr.repad_run(pr, vc, ec),
            f"repad({vc},{ec})")
    _eq(jcsr.empty_run(8, 16), csr.empty_run(8, 16, "cpu"), "empty_run")
    for n in (0, 200, 256, 257, 1000, 5000):
        for half in (False, True):
            assert csr.quantize_cap(n, half_steps=half) == \
                jcsr.quantize_cap(n, half_steps=half)


def _mk_small(src, dst, ts=None, marker=None, cap=64, vcap=32):
    """tests/test_csr.py's helper: one run in both packages."""
    n = len(src)
    ts = np.arange(n) if ts is None else np.asarray(ts)
    marker = np.zeros(n, bool) if marker is None else np.asarray(marker)
    cols = []
    for a, dt in ((src, np.int32), (dst, np.int32), (ts, np.int32),
                  (marker, bool), (np.ones(n), np.float32)):
        out = np.zeros(cap, dt)
        out[:n] = np.asarray(a, dt)
        cols.append(out)
    j, p = _both(cols)
    return (jcsr.build_run_arrays(*j, jnp.asarray(n, jnp.int32), vcap=vcap),
            csr.build_run_arrays(*p, n, vcap=vcap))


GC_CASES = {
    "vertex_aware_order": ([([0, 1], [1, 3], [0, 1], None),
                            ([0, 2], [4, 0], [2, 3], None)], 100),
    "pair_annihilation": ([([1], [2], [0], None),
                           ([1], [2], [5], [True])], 10),
    "double_insert": ([([1, 1], [2, 2], [0, 1], None),
                       ([1], [2], [5], [True])], 10),
    "orphan_tombstone": ([([1], [2], [5], [True])], 10),
    "live_snapshot": ([([1], [2], [0], None),
                       ([1], [2], [5], [True])], 3),
}


@pytest.mark.parametrize("case", sorted(GC_CASES))
@pytest.mark.parametrize("is_bottom", [False, True])
def test_merge_runs_gc_cases(case, is_bottom):
    specs, tau_min = GC_CASES[case]
    pairs = [_mk_small(s, d, ts, m) for s, d, ts, m in specs]
    want = jcsr.merge_runs([a for a, _ in pairs], tau_min, vcap=16,
                           is_bottom=is_bottom)
    got = csr.merge_runs([b for _, b in pairs], tau_min, vcap=16,
                         is_bottom=is_bottom)
    _eq(want, got, case)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_runs_random(seed):
    rng = np.random.default_rng(seed)
    pairs = [_mk_pair(rng, n=int(rng.integers(1, 120))) for _ in range(4)]
    for tau_min in (0, 400, 10 ** 6):
        for is_bottom in (False, True):
            want = jcsr.merge_runs([a for a, _ in pairs], tau_min, vcap=256,
                                   is_bottom=is_bottom)
            got = csr.merge_runs([b for _, b in pairs], tau_min, vcap=256,
                                 is_bottom=is_bottom)
            _eq(want, got, f"merge tau_min={tau_min} bottom={is_bottom}")


# ----------------------------------------------------------------- memgraph
def _batches(rng, cfg, n_batches):
    for _ in range(n_batches):
        n = int(rng.integers(1, cfg.batch_cap + 1))
        src = rng.integers(0, cfg.vmax, n).astype(np.int32)
        # A few hot sources overflow their segments into the overflow tier.
        src[: n // 4] = rng.integers(0, 4, n // 4)
        yield (src, rng.integers(0, cfg.vmax, n).astype(np.int32),
               rng.permutation(1 << 20)[:n].astype(np.int32),
               rng.random(n).astype(np.float32), rng.random(n) < 0.2)


@pytest.mark.parametrize("mode", ["memgraph", "array_only", "skiplist_only"])
def test_memgraph_insert_flush_scan(mode):
    # hash_slots barely above the row count forces long probe chains and
    # lost claims, i.e. many scatter-min claim rounds.
    kw = dataclasses.asdict(small_store_cfg(
        vmax=300, hash_slots=256, n_segments=256, batch_cap=64,
        memcache_mode=mode))
    jcfg, pcfg = JaxConfig(**kw), StoreConfig(**kw)
    jm, pm = jmg.empty_memgraph(jcfg), memgraph.empty_memgraph(pcfg, "cpu")
    rng = np.random.default_rng(5)
    bc = pcfg.batch_cap
    for src, dst, ts, prop, marker in _batches(rng, pcfg, 4):
        n = len(src)
        cols = []
        for a in (src, dst, ts, prop, marker):
            out = np.zeros(bc, a.dtype)
            out[:n] = a
            cols.append(out)
        jb = JaxEdgeBatch(*[jnp.asarray(c) for c in cols],
                          n=jnp.asarray(n, jnp.int32))
        pb = convert.edge_batch_to_torch(jb, "cpu")
        jm, jok = jmg.insert_batch(jm, jb, mode=mode)
        pm, pok = memgraph.insert_batch(pm, pb, mode=mode)
        assert bool(jok) == bool(pok)
        _eq(jm, pm, f"mem[{mode}]")
        assert jmg.memgraph_should_flush(jm, jcfg) == \
            memgraph.memgraph_should_flush(pm, pcfg)
    assert int(pm.n_rows) > 0 or mode == "skiplist_only"
    _eq(jmg.flush_arrays(jm), memgraph.flush_arrays(pm), "flush_arrays")
    _eq(jmg.backbone_stream(jm), memgraph.backbone_stream(pm), "backbone")
    vs = np.r_[np.arange(0, 300, 3), np.full(28, I32MAX)].astype(np.int32)
    _eq(jmg.lookup_rows(jm, jnp.asarray(vs)),
        memgraph.lookup_rows(pm, torch.from_numpy(vs)), "lookup_rows")
    _eq(jmg.scan_vertices_batch(jm, jnp.asarray(vs)),
        memgraph.scan_vertices_batch(pm, torch.from_numpy(vs)), "scan_batch")
    for v in (0, 1, 2, 3, 150, 299):
        _eq(jmg.scan_vertex(jm, jnp.asarray(v, jnp.int32), cap=80),
            memgraph.scan_vertex(pm, v, cap=80), f"scan_vertex({v})")
    # A state the reference built continues identically in the port.
    _eq(jm, convert.memgraph_to_torch(jm, "cpu"), "convert")


def test_memgraph_full_hash_table_reports_not_ok():
    kw = dataclasses.asdict(small_store_cfg(
        vmax=1000, hash_slots=16, n_segments=64, batch_cap=32))
    jcfg, pcfg = JaxConfig(**kw), StoreConfig(**kw)
    src = np.arange(0, 64, 2).astype(np.int32)   # 32 keys, 16 slots
    z = np.zeros(32, np.int32)
    jb = JaxEdgeBatch(jnp.asarray(src), jnp.asarray(z), jnp.asarray(z),
                      jnp.zeros(32, jnp.float32), jnp.zeros(32, bool),
                      jnp.asarray(32, jnp.int32))
    _jm, jok = jmg.insert_batch(jmg.empty_memgraph(jcfg), jb)
    _pm, pok = memgraph.insert_batch(memgraph.empty_memgraph(pcfg, "cpu"),
                                     convert.edge_batch_to_torch(jb, "cpu"))
    assert not bool(jok) and not bool(pok)


# -------------------------------------------------------------------- index
def _index_pair(rng, vmax=200, levels=4):
    """A populated index, built through the reference and carried over."""
    ji = jindex.empty_index(vmax, levels)
    for fid in range(3):
        vk = np.sort(rng.choice(vmax, 50, replace=False)).astype(np.int32)
        ji = jindex.note_l0_flush(ji, jnp.asarray(vk), jnp.asarray(40),
                                  jnp.asarray(fid, jnp.int32))
    for level in (1, 2, 3):
        vk = np.sort(rng.choice(vmax, 60, replace=False)).astype(np.int32)
        voff = np.r_[0, np.cumsum(rng.integers(1, 5, 60))].astype(np.int32)
        ji = jindex.note_compaction(
            ji, level=level, new_vkeys=jnp.asarray(vk),
            new_voff=jnp.asarray(voff), new_nv=jnp.asarray(60, jnp.int32),
            new_fid=jnp.asarray(10 + level, jnp.int32),
            range_lo=jnp.asarray(0, jnp.int32),
            range_hi=jnp.asarray(vmax, jnp.int32),
            l0_min_fid_update=jnp.asarray(-1, jnp.int32))
    return ji, convert.index_to_torch(ji, "cpu")


def test_index_flush_and_single_compaction():
    rng = np.random.default_rng(9)
    ji, pi = _index_pair(rng)
    vk = np.sort(rng.choice(200, 30, replace=False)).astype(np.int32)
    ji2 = jindex.note_l0_flush(ji, jnp.asarray(vk), jnp.asarray(25),
                               jnp.asarray(7, jnp.int32))
    pi2 = index.note_l0_flush(pi, torch.from_numpy(vk), 25, 7)
    _eq(ji2, pi2, "note_l0_flush")
    voff = np.r_[0, np.cumsum(rng.integers(1, 4, 30))].astype(np.int32)
    for level, upd in ((1, 5), (2, -1), (3, -1)):
        want = jindex.note_compaction(
            ji2, level=level, new_vkeys=jnp.asarray(vk),
            new_voff=jnp.asarray(voff), new_nv=jnp.asarray(28, jnp.int32),
            new_fid=jnp.asarray(30, jnp.int32),
            range_lo=jnp.asarray(40, jnp.int32),
            range_hi=jnp.asarray(150, jnp.int32),
            l0_min_fid_update=jnp.asarray(upd, jnp.int32))
        got = index.note_compaction(
            pi2, level=level, new_vkeys=torch.from_numpy(vk),
            new_voff=torch.from_numpy(voff), new_nv=28, new_fid=30,
            range_lo=40, range_hi=150, l0_min_fid_update=upd)
        _eq(want, got, f"note_compaction level {level}")
    vs = np.r_[np.arange(0, 200, 7), [I32MAX] * 3].astype(np.int32)
    _eq(jindex.lookup_batch(ji2, jnp.asarray(vs)),
        index.lookup_batch(pi2, torch.from_numpy(vs)), "lookup_batch")
    for v in (0, 57, 199):
        _eq(jindex.lookup(ji2, jnp.asarray(v)), index.lookup(pi2, v),
            f"lookup({v})")


@pytest.mark.parametrize("level,upd", [(1, 9), (2, -1), (3, -1)])
def test_index_folded_commit_equals_sequential_calls(level, upd):
    """One commit's folded update == the reference's call per output
    segment and per annihilated gap, when the source range spans the
    output (every L0 compaction; a partial compaction without a wider
    target overlap)."""
    rng = np.random.default_rng(level)
    ji, pi = _index_pair(rng)
    lo, hi = 20, 180
    segs, start = [], 25
    for fid in (40, 41, 42):          # disjoint segments, gaps between
        vk = np.sort(rng.choice(np.arange(start, start + 40), 15,
                                replace=False)).astype(np.int32)
        voff = np.r_[0, np.cumsum(rng.integers(1, 4, 15))].astype(np.int32)
        segs.append((vk, voff, fid))
        start += 50
    ranges = [(int(vk[0]), int(vk[-1]) + 1) for vk, _vo, _f in segs]
    gaps = [(lo, ranges[0][0])] + [(ranges[i][1], ranges[i + 1][0])
                                   for i in range(2)] + [(ranges[2][1], hi)]
    want = ji
    for (vk, voff, fid), (rlo, rhi) in zip(segs, ranges):
        want = jindex.note_compaction(
            want, level=level, new_vkeys=jnp.asarray(vk),
            new_voff=jnp.asarray(voff), new_nv=jnp.asarray(15, jnp.int32),
            new_fid=jnp.asarray(fid, jnp.int32),
            range_lo=jnp.asarray(rlo, jnp.int32),
            range_hi=jnp.asarray(rhi, jnp.int32),
            l0_min_fid_update=jnp.asarray(upd, jnp.int32))
    for glo, ghi in gaps:
        want = jindex.note_compaction(
            want, level=level,
            new_vkeys=jnp.full((1,), I32MAX, jnp.int32),
            new_voff=jnp.zeros((2,), jnp.int32),
            new_nv=jnp.asarray(0, jnp.int32),
            new_fid=jnp.asarray(I32MAX, jnp.int32),
            range_lo=jnp.asarray(glo, jnp.int32),
            range_hi=jnp.asarray(ghi, jnp.int32),
            l0_min_fid_update=jnp.asarray(upd, jnp.int32))
    got = index.note_compaction_many(
        pi, level=level,
        writes=[(torch.from_numpy(vk), torch.from_numpy(voff), 15, fid)
                for vk, voff, fid in segs],
        ranges=ranges + gaps, src_ranges=[(lo, hi)], l0_min_fid_update=upd)
    _eq(want, got, "folded commit")
