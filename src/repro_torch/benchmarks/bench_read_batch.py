"""Batched vs per-vertex neighbor resolution on a multi-level store.

The read-path claim of the batched subsystem: `Snapshot.neighbors_batch`
resolves a whole query vector in a constant number of device passes per
visible run, while the per-vertex loop pays one host/dispatch round-trip per
vertex per run.  The store is arranged so MemGraph, L0 and L1 are ALL
populated (every tier participates in every resolve).

Rows: per-vertex and batched cost at 1k and 10k queries; `derived` carries
the speedup (acceptance: >= 5x at 1000 vertices).  The port of
``benchmarks/bench_read_batch.py``: every store on the suite's device.

The snapshot-depth sweep (`read_depth*` rows) measures the pipelined read
path where it lives: batched resolves against 1/2/4/8 visible runs, warm
(all arrays resident) and evicted-cold (every run dropped to its segment
file, reloaded through the background prefetcher mid-batch).  Acceptance:
>= 1.5x vs the pre-pipeline path at depth >= 4.
"""
from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np

from ..core import LSMGraph
from .common import (cli_device, emit, graph_edges, scale, store_cfg,
                     suite_device)


def _build_store(dev) -> LSMGraph:
    V = scale().V
    g = LSMGraph(store_cfg(), device=dev)
    src, dst = graph_edges(seed=11)
    g.insert_edges(src, dst)
    g.flush_memgraph()
    g.compact_l0()                    # drain: everything compacts into L1+
    # (explicit — at smoke scale the L0 run limit never auto-triggers)
    rng = np.random.default_rng(12)
    g.insert_edges(rng.integers(0, V, 1 << 11),
                   rng.integers(0, V, 1 << 11))
    g.flush_memgraph()                # under the run limit -> a fresh L0 run
    g.insert_edges(rng.integers(0, V, 1 << 10),
                   rng.integers(0, V, 1 << 10))  # repopulates MemGraph
    assert int(g.mem.ne) > 0 and len(g.levels[0]) > 0 and \
        sum(r.ne for r in g.levels[1]) > 0, "need MemGraph + L0 + L1"
    return g


def _depth_store(root: str, n_runs: int, dev):
    """A durable store with exactly ``n_runs`` visible L0 runs (MemGraph
    empty, no compaction): every batched resolve touches all of them, and
    each run has a segment file so it can be evicted cold.  Per-run size is
    held CONSTANT across the sweep (and below the MemGraph flush threshold,
    so no auto-flush splits a run) — depth k measures k-run cost at fixed
    run size, not a bigger store."""
    import dataclasses

    from ..storage import open_store

    cfg = dataclasses.replace(store_cfg(), l0_run_limit=n_runs + 64)
    g = open_store(root, cfg, device=dev, wal_sync="off")
    src, dst = graph_edges(seed=31)
    per = min(cfg.mem_edges - cfg.batch_cap, len(src) // n_runs)
    for i in range(n_runs):
        g.insert_edges(src[i * per:(i + 1) * per], dst[i * per:(i + 1) * per])
        g.flush_memgraph()
    assert len(g.levels[0]) == n_runs and int(g.mem.ne) == 0
    return g


def _evict_all(g: LSMGraph) -> int:
    # The engine's eviction lever, not a raw per-run evict: it also drops
    # the state-owned read spine, so the next snapshot truly rebuilds from
    # disk instead of serving the cached merged view of the evicted bytes.
    return g.durability.evict_all_segments()


def depth_sweep(dev) -> list:
    """read_depth{k}_{warm,cold} rows: median-of-3 batched resolve against
    k visible runs.  Warm reps share one snapshot (amortized read spine —
    the steady-state serving shape); cold reps each pin a FRESH snapshot
    after evicting every segment, so the resolve pays the full pipeline:
    prefetched segment reloads + spine merge + annihilation."""
    sc = scale()
    rows = []
    nq = 256 if sc.smoke else 4096
    depths = (1, 2) if sc.smoke else (1, 2, 4, 8)
    reps = 3
    rng = np.random.default_rng(33)
    vs = rng.integers(0, sc.V, nq).astype(np.int64)
    for depth in depths:
        root = tempfile.mkdtemp(prefix=f"lsmg-bench-depth{depth}-")
        g = _depth_store(root, depth, dev)
        try:
            snap = g.snapshot()
            snap.neighbors_batch(vs)            # warm kernels + spine
            warm = []
            for _ in range(reps):
                t0 = time.perf_counter()
                out = snap.neighbors_batch(vs)
                warm.append(time.perf_counter() - t0)
            assert len(out) == nq
            snap.release()
            cold = []
            for _ in range(reps):
                assert _evict_all(g) == depth, "cold rep measured warm runs"
                cold_snap = g.snapshot()
                t0 = time.perf_counter()
                cold_snap.neighbors_batch(vs)
                cold.append(time.perf_counter() - t0)
                cold_snap.release()
            w, c = sorted(warm)[reps // 2], sorted(cold)[reps // 2]
            rows.append((f"read_depth{depth}_warm", w * 1e6,
                         f"qps={nq / w:.0f}"))
            rows.append((f"read_depth{depth}_cold", c * 1e6,
                         f"qps={nq / c:.0f};reload_ratio={c / w:.2f}x"))
        finally:
            g.close()
            shutil.rmtree(root, ignore_errors=True)
    return rows


def run(device=None) -> list:
    dev = suite_device(device)
    sc = scale()
    g = _build_store(dev)
    snap = g.snapshot()
    rng = np.random.default_rng(13)
    rows = []
    # per-vertex loop cost is per-call; a sample suffices
    scalar_sample = 50 if sc.smoke else 1000
    for nq in ((1000,) if sc.smoke else (1000, 10000)):
        vs = rng.integers(0, sc.V, nq).astype(np.int64)
        # warm both paths (first kernel builds excluded from timing)
        snap.neighbors_scalar(int(vs[0]))
        snap.neighbors_batch(vs[:64])
        snap.neighbors_batch(vs)

        sample = vs[:min(nq, scalar_sample)]
        t0 = time.perf_counter()
        for v in sample:
            snap.neighbors_scalar(int(v))
        per_vertex_s = (time.perf_counter() - t0) / len(sample)

        t0 = time.perf_counter()
        out = snap.neighbors_batch(vs)
        batch_total_s = time.perf_counter() - t0
        assert len(out) == nq

        speedup = (per_vertex_s * nq) / batch_total_s
        rows.append((f"read_scalar_loop_{nq}", per_vertex_s * nq * 1e6,
                     f"per_vertex_us={per_vertex_s * 1e6:.1f}"))
        rows.append((f"read_batched_{nq}", batch_total_s * 1e6,
                     f"speedup={speedup:.1f}x"))
    snap.release()
    rows.extend(depth_sweep(dev))
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
