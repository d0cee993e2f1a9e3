"""Vertex-presence filters in the port, against the JAX package's.

The cases of the reference's ``tests/test_filters.py`` that no port test
answered (its scheduler cases are in ``test_torch_shard.py``): the
false-positive bound, the empty filter, ``from_words`` rejecting a size
that is not a power of two, the filter metrics of scalar reads, cold runs
staying cold for vertices every filter rejects, the spine cache keeping
one generation of history, and the scrub rebuilding a rotted filter
section byte-identical.  Each case runs the same inputs (numpy seeds)
through both packages, the port on the CPU: the membership answers, the
counter deltas, the bytes loaded cold, the cached spines' fids and the
segment files must be equal, and the reference's own assertions must hold
on the port's values.  Tolerance: none.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import small_store_cfg  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro.core import filters as jfilters  # noqa: E402
from repro.core.types import StoreConfig as JaxConfig  # noqa: E402
from repro.storage import faultfs as jfaultfs  # noqa: E402
from repro.storage import open_store as jopen_store  # noqa: E402
from repro.storage import segments as jseg  # noqa: E402
from repro.storage.errors import CorruptionError as JCorruption  # noqa
from repro_torch import obs  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig, filters  # noqa: E402
from repro_torch.storage import faultfs, open_store  # noqa: E402
from repro_torch.storage import segments as pseg  # noqa: E402
from repro_torch.storage.errors import CorruptionError  # noqa: E402

PKGS = {
    "jax": dict(graph=JaxGraph, cfg=JaxConfig, open=jopen_store,
                seg=jseg, faultfs=jfaultfs, corruption=JCorruption,
                obs=jobs, filters=jfilters, kw={}),
    "torch": dict(graph=LSMGraph, cfg=StoreConfig, open=open_store,
                  seg=pseg, faultfs=faultfs, corruption=CorruptionError,
                  obs=obs, filters=filters, kw=dict(device="cpu")),
}


def _durable_cfg(pkg, **kw):
    base = dict(vmax=1 << 12, mem_edges=1 << 12, l0_run_limit=64)
    base.update(kw)
    return PKGS[pkg]["cfg"](**base)


def _open(pkg, root, cfg, **kw):
    p = PKGS[pkg]
    return p["open"](root, cfg, **p["kw"], **kw)


def _one_segment(root):
    segs = sorted(glob.glob(os.path.join(root, "segments", "*.csr")))
    assert segs
    return segs[-1]


def _mixed_store(pkg):
    """The reference's mixed store: three flushed L0 runs, a delete and a
    MemGraph tail."""
    cfg = small_store_cfg(l0_run_limit=64)
    p = PKGS[pkg]
    g = p["graph"](p["cfg"](**dataclasses.asdict(cfg)), **p["kw"])
    rng = np.random.default_rng(17)
    for _ in range(3):
        src = rng.integers(0, 1 << 10, 400).astype(np.int64)
        dst = rng.integers(0, 1 << 12, 400).astype(np.int64)
        g.insert_edges(src, dst)
        g.flush_memgraph()
    g.delete_edges(src[:50], dst[:50])
    g.insert_edges(rng.integers(0, 1 << 10, 100).astype(np.int64),
                   rng.integers(0, 1 << 12, 100).astype(np.int64))
    return g


def _both(scenario, *args):
    want = scenario("jax", *args)
    got = scenario("torch", *args)
    assert got == want
    return got


# ------------------------------------------------------------ filter core
def test_filter_false_positive_rate_bounded():
    rng = np.random.default_rng(3)
    members = rng.integers(0, 1 << 30, 2000).astype(np.int64)
    absent = np.setdiff1d(
        rng.integers(1 << 30, 1 << 31, 20000).astype(np.int64), members)
    want = jfilters.from_vkeys(members).might_contain(absent)
    got = filters.from_vkeys(members).might_contain(absent)
    np.testing.assert_array_equal(got, want)
    # 16 bits/key, k=4 gives ~0.2% theoretical; 2% is a generous ceiling
    # that still catches a broken hash (which false-positives at ~100%).
    assert got.mean() < 0.02


def test_empty_filter_rejects_everything():
    vs = np.arange(64, dtype=np.int64)
    for f in (jfilters, filters):
        got = f.from_vkeys(np.empty(0, np.int64)).might_contain(vs)
        assert got.shape == (64,) and not got.any()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_from_words_rejects_non_pow2(pkg):
    with pytest.raises(ValueError):
        PKGS[pkg]["filters"].from_words(np.zeros(3, np.uint32), 96)


# ------------------------------------------------------- read-path gates
def _metrics(pkg):
    g = _mixed_store(pkg)
    o = PKGS[pkg]["obs"]
    checked = o.counter("read_filter_checked_total", store=g.obs_label)
    skipped = o.counter("read_filter_skipped_total", store=g.obs_label)
    c0, s0 = checked.value, skipped.value
    with g.snapshot() as snap:
        # Scalar reads of vertices far outside the ingested src range.
        hits = sum(len(snap.neighbors_scalar(v))
                   for v in range(1 << 11, (1 << 11) + 32))
    return dict(checked=checked.value - c0, skipped=skipped.value - s0,
                hits=hits)


def test_filter_metrics_flow():
    got = _both(_metrics)
    assert got["checked"] > 0
    assert got["skipped"] > 0
    assert got["hits"] == 0


def _cold(pkg, root):
    root = str(root / pkg)
    g = _open(pkg, root, _durable_cfg(pkg))
    src = np.arange(0, 1 << 11, 2, dtype=np.int64)      # evens only
    g.insert_edges(src, src + 1)
    g.flush_memgraph()
    g.durability.evict_all_segments()
    cold0 = g.io.cold_load
    hits = 0
    with g.snapshot() as snap:
        for v in range(1, 81, 2):                        # absent odds
            hits += len(snap.neighbors_scalar(v))
    cold_absent = g.io.cold_load - cold0
    with g.snapshot() as snap:
        present = [int(x) for x in snap.neighbors_scalar(2)]
    cold_present = g.io.cold_load - cold0
    g.close()
    return dict(hits=hits, cold_absent=cold_absent, present=present,
                cold_present=cold_present)


def test_cold_runs_stay_cold_for_absent_vertices(tmp_path):
    """After eviction, scalar reads of vertices every filter rejects never
    reload a segment; a present vertex pays a real load, of the same
    bytes in both packages."""
    got = _both(_cold, tmp_path)
    assert got["hits"] == 0
    assert got["cold_absent"] == 0                       # nothing loaded
    assert got["present"] == [3]                         # a present even
    assert got["cold_present"] > 0                       # real load paid


def _spine_cache(pkg):
    g = _mixed_store(pkg)
    with g.snapshot() as old_snap:
        old_snap.neighbors_batch(np.arange(8, dtype=np.int64))
        old_fids = g._spine_cache._slots[0].fids
        g.insert_edges(np.arange(64, dtype=np.int64),
                       np.arange(64, dtype=np.int64) + 1)
        g.flush_memgraph()
        with g.snapshot() as new_snap:
            new_snap.neighbors_batch(np.arange(8, dtype=np.int64))
        fids = [tuple(s.fids) for s in g._spine_cache._slots]
    return dict(old=tuple(old_fids), slots=fids)


def test_spine_cache_keeps_one_generation_of_history():
    """Two-slot cache: a snapshot pinned before a flush still resolves
    against the previous epoch without evicting the new epoch's spine."""
    got = _both(_spine_cache)
    assert len(got["slots"]) == 2
    assert got["slots"][1] == got["old"]          # history retained
    assert got["slots"][0] > got["old"]           # new epoch newest-first


def _scrub(pkg, root):
    p = PKGS[pkg]
    root = str(root / pkg)
    g = _open(pkg, root, _durable_cfg(pkg), wal_sync="always")
    g.insert_edges(np.arange(0, 600, 2, dtype=np.int64),
                   np.arange(0, 600, 2, dtype=np.int64) + 1)
    g.flush_memgraph()
    seg = _one_segment(root)
    want_bytes = open(seg, "rb").read()
    meta = p["seg"].read_segment_header(seg)
    sect_off = p["seg"]._HDR.size + p["seg"].body_nbytes(meta["nv"],
                                                          meta["ne"])
    g.durability.evict_all_segments()
    # Flip a payload bit inside the section, beyond the 16-byte header.
    p["faultfs"].flip_bit(seg, offset=sect_off + p["seg"]._FHDR.size + 1)
    with pytest.raises(p["corruption"]):
        p["seg"].verify_segment(seg)
    stats = g.durability.scrub_once()
    after = open(seg, "rb").read()
    degraded = g.degraded_ranges()
    g.close()
    return dict(section=sect_off < len(want_bytes), rebuilt=stats["rebuilt"],
                identical=after == want_bytes, degraded=degraded,
                name=os.path.basename(seg), bytes=want_bytes)


def test_filter_section_corruption_scrub_rebuilds_byte_identical(tmp_path):
    """Rot ONLY the filter section of an evicted segment: the scrubber
    catches it (the body CRC alone would pass), quarantines it and
    rebuilds it from the WAL, byte-identical INCLUDING the section; the
    segment files of both packages are equal."""
    got = _both(_scrub, tmp_path)
    assert got["section"]                          # v2: a section exists
    assert got["rebuilt"] == 1
    assert got["identical"]
    assert got["degraded"] == ()
