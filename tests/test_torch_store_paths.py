"""The port's store on paths the main sequence does not reach, held
against the JAX package: the sealed MemGraph riding the read spine, a
dropped spine rebuilt, a store without a card, and the two faults of the
reference's compaction (ROADMAP, faults) — one reproduced on purpose, one
fixed in the port.  Tolerance: none (integer and bool results)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro.core import StoreConfig as JaxConfig  # noqa: E402
from repro.core import store as jax_store  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core import store as port_store  # noqa: E402
from test_torch_store import _apply, _configs, _np_eq, _ops  # noqa: E402


def test_duplicate_insert_gc_matches_reference():
    """A fault of the reference that the port reproduces on purpose (both
    packages must agree byte for byte): an edge inserted twice and then
    deleted comes back when the older insert sits on a deeper level than
    the (insert, delete) pair that compaction's GC annihilates — the
    last-writer-wins answer is []."""
    kw = dataclasses.asdict(small_store_cfg(l0_run_limit=1))
    out = []
    for store in (JaxGraph(JaxConfig(**kw)),
                  LSMGraph(StoreConfig(**kw), device="cpu")):
        store.insert_edges([1], [2])
        store.flush_memgraph()          # L0 -> L1 (l0_run_limit=1)
        store.compact_partial(1)        # L1 -> L2
        store.insert_edges([1], [2])
        store.delete_edges([1], [2])
        store.flush_memgraph()          # [ins, del] annihilate in L1
        with store.snapshot() as snap:
            out.append((store.level_sizes(), snap.neighbors(1).tolist(),
                        snap.neighbors_scalar(1).tolist()))
    assert out[0] == out[1] == ([0, 0, 1, 0, 0], [2], [2])


def test_partial_compaction_keeps_uncompacted_source_entries():
    """A fault of the reference that the port fixes: a partial compaction
    L1 -> L2 whose L2 overlap spans another L1 segment clears that
    segment's L1 index entries too, so the reference loses vertex 5's L1
    edges; the port clears the L1 column over the compacted source range
    only and returns the last-writer-wins answer."""
    kw = dataclasses.asdict(small_store_cfg(l0_run_limit=1,
                                            seg_target_edges=4))
    out = []
    for store in (JaxGraph(JaxConfig(**kw)),
                  LSMGraph(StoreConfig(**kw), device="cpu")):
        store.insert_edges([1, 1, 5, 5], [10, 11, 10, 11])
        store.flush_memgraph()          # one L1 segment [1, 5]
        store.compact_partial(1)        # -> L2 segment [1, 5]
        store.insert_edges([1, 1, 1, 5, 5, 5], [12, 13, 14] * 2)
        store.flush_memgraph()          # L1 segments [1, 1] and [5, 5]
        store.compact_partial(1)        # [1, 1] + L2 [1, 5] -> L2
        ranges = [[(r.min_vid, r.max_vid) for r in lvl]
                  for lvl in store.levels]
        with store.snapshot() as snap:
            out.append((ranges, snap.neighbors(5).tolist(),
                        snap.neighbors_scalar(5).tolist(),
                        snap.neighbors(1).tolist()))
    jax_out, port_out = out
    assert jax_out[0] == port_out[0] == [[], [(5, 5)], [(1, 1), (5, 5)],
                                         [], []]
    assert port_out[1:] == ([10, 11, 12, 13, 14],) * 3
    assert jax_out[1:] == ([10, 11], [10, 11], [10, 11, 12, 13, 14])


@pytest.mark.parametrize("with_runs", [True, False])
def test_sealed_memgraph_rides_the_spine(with_runs):
    """The state between a flush's rotate and its commit: the full
    MemGraph is sealed (``mem_full``) and merged into the read spine while
    a fresh MemGraph takes writes.  Reads of that state equal the
    reference's and the reads before the rotate."""
    from repro.core import memgraph as jmg
    from repro_torch.core import memgraph as pmg
    jcfg, pcfg = _configs("small")
    js, ps = JaxGraph(jcfg), LSMGraph(pcfg, device="cpu")
    ops = _ops(pcfg.vmax, seed=3)[:4] if with_runs else []
    tail = ("ins", np.arange(40), np.arange(40)[::-1].copy(),
            np.full(40, 0.5, np.float32))
    for op in ops + [tail]:
        _apply(js, op)
        _apply(ps, op)
    assert bool(ps.levels[0] or ps.levels[1]) == with_runs
    probe = np.arange(0, pcfg.vmax, 2)
    with ps.snapshot() as snap:
        before = snap.neighbors_batch(probe)
    out = []
    for store, mod, cls, handle in (
            (js, jmg, jax_store.Snapshot, jax_store._SpineHandle),
            (ps, pmg, port_store.Snapshot, port_store._SpineHandle)):
        st = store._state
        fresh = (mod.empty_memgraph(store.cfg) if store is js
                 else mod.empty_memgraph(store.cfg, "cpu"))
        sealed = dataclasses.replace(st, mem=fresh, mem_full=st.mem,
                                     mem_full_id=st.mem_id, spine=handle())
        out.append(cls(store, sealed).neighbors_batch(probe))
    for v, j, p, b in zip(probe, out[0], out[1], before):
        _np_eq(j, p, f"sealed-tier read {v}")
        _np_eq(b, p, f"sealed vs active read {v}")


def test_drop_read_spine_rebuilds_the_same_reads():
    _jcfg, pcfg = _configs("small")
    store = LSMGraph(pcfg, device="cpu")
    for op in _ops(pcfg.vmax, seed=2)[:6]:
        _apply(store, op)
    probe = np.arange(0, pcfg.vmax, 3)
    with store.snapshot() as snap:
        first = snap.neighbors_batch(probe, return_props=True)
    builds = port_store._MERGE_STATS.snapshot_stats()["spine_build"]
    store.drop_read_spine()
    with store.snapshot() as snap:
        again = snap.neighbors_batch(probe, return_props=True)
    assert port_store._MERGE_STATS.snapshot_stats()["spine_build"] == \
        builds + 1
    for (d1, p1), (d2, p2) in zip(first, again):
        _np_eq(d1, d2, "dst after drop_read_spine")
        _np_eq(p1, p2, "prop after drop_read_spine")


def test_device_none_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LSMGraph(StoreConfig(vmax=64, mem_edges=64, batch_cap=16))
