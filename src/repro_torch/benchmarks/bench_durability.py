"""Durability cost: ingest throughput WAL-on vs WAL-off, recovery time.

Rows:
  durability/ingest_<mode>   — us per edge while ingesting E edges
                               (derived: edges/s and bytes on disk)
  durability/recover_<n>     — reopen (manifest replay + segment load +
                               WAL tail replay) for an n-edge store
                               (derived: edges recovered)

The acceptance bar: WAL-on ingest within 2x of WAL-off — the group-commit
batching keeps fsync off the ingest critical path.  The port of
``benchmarks/bench_durability.py``: every store on the suite's device.
"""
from __future__ import annotations

import shutil
import tempfile
import time

from .common import (Row, cli_device, emit, graph_edges, scale, store_cfg,
                     suite_device, sync)


def _ingest(store, src, dst, dev) -> float:
    t0 = time.perf_counter()
    store.insert_edges(src, dst)
    sync(dev)
    return time.perf_counter() - t0


def main(device=None) -> None:
    from ..core import LSMGraph
    from ..storage import open_store

    dev = suite_device(device)
    src, dst = graph_edges()
    n = len(src)
    rows: list[Row] = []

    # Warm the kernels (first builds and launches of flush/compaction) so
    # the WAL-off baseline doesn't pay what the later runs then reuse.
    warm = LSMGraph(store_cfg(), device=dev)
    warm.insert_edges(src, dst)
    del warm

    # Ingest modes, interleaved median-of-3 (container I/O jitter dwarfs the
    # per-mode deltas on a single run):
    #   mem    — plain in-memory store (the seed's proxy mode)
    #   off    — durable segments+manifest, WAL fsync disabled
    #   batch  — WAL group commit (fsync off the critical path)
    #   always — fsync every WAL append
    modes = ("mem", "off", "batch", "always")
    times = {m: [] for m in modes}
    dirs = []
    keep_dir = {}
    disk = {}
    for _trial in range(1 if scale().smoke else 3):
        for mode in modes:
            if mode == "mem":
                g = LSMGraph(store_cfg(), device=dev)
            else:
                d = tempfile.mkdtemp(prefix=f"lsmg-bench-{mode}-")
                dirs.append(d)
                g = open_store(d, store_cfg(), device=dev, wal_sync=mode)
            times[mode].append(_ingest(g, src, dst, dev))
            if mode != "mem":
                disk[mode] = g.disk_bytes()  # real on-disk bytes
                g.close()
                keep_dir[mode] = d
    med = {m: sorted(ts)[len(ts) // 2] for m, ts in times.items()}
    for mode in modes:
        dt = med[mode]
        extra = "" if mode == "mem" else f";disk={disk[mode]}"
        rows.append((f"durability/ingest_{mode}", dt / n * 1e6,
                     f"edges_s={n/dt:.0f}{extra}"))
    rows.append(("durability/wal_overhead", 0.0,
                 f"ratio={med['batch']/med['off']:.2f}x"))

    # Recovery time vs store size (reuse the group-commit store + a smaller
    # one): reopen = manifest replay + segment load + WAL tail replay.
    small = tempfile.mkdtemp(prefix="lsmg-bench-small-")
    dirs.append(small)
    k = max(n // 4, 1)
    gs = open_store(small, store_cfg(), device=dev, wal_sync="batch")
    gs.insert_edges(src[:k], dst[:k])
    gs.close()
    for label, d, edges in (("recover_small", small, k),
                            ("recover_full", keep_dir["batch"], n)):
        t0 = time.perf_counter()
        g = open_store(d, device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        with g.snapshot() as snap:
            nv = len(snap.vertices())
        g.close()
        rows.append((f"durability/{label}", dt * 1e6,
                     f"edges={edges};vertices={nv}"))

    emit(rows)
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    main(cli_device())
