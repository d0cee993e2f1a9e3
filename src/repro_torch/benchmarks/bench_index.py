"""Fig 16 (multi-level index on/off) + Fig 17 (index vs Bloom-filter probing):
point-read cost and I/O across a deep multi-level store (the port of
``benchmarks/bench_index.py``).

A point read goes through ``Snapshot.neighbors_scalar``: with the index on,
one (fid, offset) per L1+ level; with it off, a binary search of every run
that may hold the vertex (``csr.run_lookup``, a ``torch.searchsorted``, as
the reference's is a ``jnp.searchsorted``: neither reaches the batched
search kernel, which only the per-run probe ``run_lookup_batch(
use_pallas=True)`` launches)."""
from __future__ import annotations

import time

import numpy as np

from ..core import LSMGraph
from .common import (cli_device, emit, graph_edges, scale, store_cfg,
                     suite_device, sync)


def run(device=None) -> list:
    dev = suite_device(device)
    V = scale().V
    src, dst = graph_edges(seed=4)
    g = LSMGraph(store_cfg(), device=dev)
    g.insert_edges(src, dst)
    hot = np.unique(src)[:300]
    rows = []
    for use_index in (True, False):
        object.__setattr__(g.cfg, "use_multilevel_index", use_index)
        snap = g.snapshot()
        r0 = g.io.analytics_read
        sync(dev)
        t0 = time.perf_counter()
        for v in hot:
            snap.neighbors(int(v))
        dt = (time.perf_counter() - t0) / len(hot)
        snap.release()
        tag = "with_index" if use_index else "without_index"
        rows.append((f"fig16_read_{tag}", dt * 1e6,
                     f"io_bytes={(g.io.analytics_read - r0)//len(hot)}"))
    object.__setattr__(g.cfg, "use_multilevel_index", True)

    # Fig 17: the LSM-KV baseline's Bloom-filtered probing vs our index.
    from ..baselines import LSMKVStore
    kv = LSMKVStore(V, mem_cap=1 << 12)
    kv.insert_edges(src, dst)
    t0 = time.perf_counter()
    for v in hot:
        kv.neighbors(int(v))
    dt_bloom = (time.perf_counter() - t0) / len(hot)
    rows.append(("fig17_bloom_probe_lsm_kv", dt_bloom * 1e6,
                 f"io_bytes={kv.io.read//len(hot)}"))
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
