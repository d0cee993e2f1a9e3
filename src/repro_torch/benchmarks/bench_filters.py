"""Presence-filter depth sweep: runs probed + cold bytes, filters on/off.

The filter tentpole's two claims, measured head-to-head at each L0 depth:

* **device work**: the vectorized presence test drops (run, query) pairs
  before spine rank + gather, so ``runs_per_query`` stays ~flat as depth
  grows when queries touch one run's keyspace;
* **cold I/O**: per-run reads of filter-rejected vertices never
  ``ensure_loaded`` an evicted segment, so cold reload bytes track the
  runs that MIGHT hold the vertex, not the runs that exist.

Each depth builds ``k`` L0 runs over DISJOINT source-vertex ranges (the
selective case filters exist for), then runs the same workload with
filters on and with ``LSMG_READ_FILTERS=0``: one batched resolve over run
0's range (probe accounting), then evict-all + a scalar sweep of run 0's
range (cold-reload accounting).  Rows:

    bench_filters_depth{k}_{on,off}  us_per_call = whole workload
    derived = rpq=<runs probed per query>;cold_kb=<segment reload KiB>

The port of ``benchmarks/bench_filters.py``: every store on the suite's
device, the filters tested by ``presence_matrix`` on the batched read.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time

import numpy as np

from .. import obs
from .common import cli_device, emit, scale, store_cfg, suite_device, sync


def _disjoint_store(root: str, n_runs: int, dev):
    """Durable store with ``n_runs`` L0 runs, run ``i`` holding sources
    only from slice ``i`` of the vertex space (MemGraph empty, no
    compaction — every batched resolve sees all k runs)."""
    from ..storage import open_store

    sc = scale()
    V = sc.V
    cfg = dataclasses.replace(store_cfg(), l0_run_limit=n_runs + 64)
    per = min(cfg.mem_edges - cfg.batch_cap, 512 if sc.smoke else 2048)
    g = open_store(root, cfg, device=dev, wal_sync="off")
    stride = V // n_runs
    rng = np.random.default_rng(41)
    for i in range(n_runs):
        src = (i * stride + rng.integers(0, stride, per)).astype(np.int64)
        dst = rng.integers(0, V, per).astype(np.int64)
        g.insert_edges(src, dst)
        g.flush_memgraph()
    assert len(g.levels[0]) == n_runs and int(g.mem.ne) == 0
    return g


def _workload(g, vs_batch: np.ndarray, vs_scalar: np.ndarray,
              dev) -> dict:
    """One measured pass: batched resolve (warm, probe accounting), then
    evict-all + scalar sweep (cold-reload accounting)."""
    probes = obs.counter("read_runs_probed_total", store=g.obs_label)
    queries = obs.counter("read_queries_total", store=g.obs_label)
    with g.snapshot() as snap:                    # kernels + spine warmup
        snap.neighbors_batch(vs_batch)
        for v in vs_scalar[:8]:                   # scalar-path warmup
            snap.neighbors_scalar(int(v))
    sync(dev)
    p0, q0, c0 = probes.value, queries.value, g.io.cold_load
    t0 = time.perf_counter()
    with g.snapshot() as snap:
        snap.neighbors_batch(vs_batch)
    g.durability.evict_all_segments()
    with g.snapshot() as snap:
        for v in vs_scalar:
            snap.neighbors_scalar(int(v))
    sync(dev)
    dt = time.perf_counter() - t0
    dq = max(queries.value - q0, 1)
    return {"us": dt * 1e6,
            "rpq": (probes.value - p0) / dq,
            "cold_kb": (g.io.cold_load - c0) / 1024.0}


def run(device=None) -> list:
    dev = suite_device(device)
    sc = scale()
    V = sc.V
    rows = []
    depths = (2,) if sc.smoke else (2, 4, 8)
    nq = 128 if sc.smoke else 1024
    n_scalar = 32 if sc.smoke else 128
    rng = np.random.default_rng(43)
    prev = os.environ.get("LSMG_READ_FILTERS")
    try:
        for depth in depths:
            stride = V // depth
            vs_batch = rng.integers(0, stride, nq).astype(np.int64)
            vs_scalar = rng.integers(0, stride, n_scalar).astype(np.int64)
            # Prime pass (discarded): both modes share the process's first
            # kernel builds and launches, so whichever mode ran first would
            # otherwise eat them and the on/off times wouldn't be
            # comparable.
            for mode in ("prime", "on", "off"):
                os.environ["LSMG_READ_FILTERS"] = "0" if mode == "off" \
                    else "1"
                root = tempfile.mkdtemp(
                    prefix=f"lsmg-bench-filters-{depth}-{mode}-")
                g = _disjoint_store(root, depth, dev)
                try:
                    m = _workload(g, vs_batch, vs_scalar, dev)
                finally:
                    g.close()
                    shutil.rmtree(root, ignore_errors=True)
                if mode == "prime":
                    continue
                rows.append((f"bench_filters_depth{depth}_{mode}",
                             m["us"],
                             f"rpq={m['rpq']:.4f};"
                             f"cold_kb={m['cold_kb']:.0f}"))
    finally:
        if prev is None:
            os.environ.pop("LSMG_READ_FILTERS", None)
        else:
            os.environ["LSMG_READ_FILTERS"] = prev
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
