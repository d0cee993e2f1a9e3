"""Fig 15: MemGraph vs array-only vs skiplist-only memory cache structures —
update throughput + vertex-scan time (paper §5.5; the port of
``benchmarks/bench_memcache.py``)."""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import LSMGraph
from ..core import memgraph as mg_mod
from .common import (cli_device, emit, graph_edges, store_cfg, suite_device,
                     sync)


def run(device=None) -> list:
    dev = suite_device(device)
    src, dst = graph_edges(seed=3)
    src, dst = src[:20000], dst[:20000]
    rows = []
    for mode in ("memgraph", "array_only", "skiplist_only"):
        cfg = dataclasses.replace(
            store_cfg(), memcache_mode=mode,
            mem_edges=1 << 14, ovf_cap=1 << 15, n_segments=1 << 13,
            hash_slots=1 << 14)
        g = LSMGraph(cfg, device=dev)
        t0 = time.perf_counter()
        g.insert_edges(src, dst)
        sync(dev)
        dt = time.perf_counter() - t0
        # scan time over cached (unflushed) vertices
        hot = np.unique(src)[:200]
        t0 = time.perf_counter()
        for v in hot:
            mg_mod.scan_vertex(g.mem, int(v), cap=256)
            sync(dev)
        t_scan = (time.perf_counter() - t0) / len(hot)
        rows.append((f"fig15_ingest_{mode}", dt / len(src) * 1e6,
                     f"eps={len(src)/dt:.0f}"))
        rows.append((f"fig15_scan_{mode}", t_scan * 1e6,
                     f"cached={int(g.mem.ne)}"))
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
