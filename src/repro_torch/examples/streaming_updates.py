"""Streaming ingestion with concurrent analytics — the paper's Fig 18
mixed workload, on the thread-safe concurrent store (the port of
``examples/streaming_updates.py``).

    PYTHONPATH=src python -m repro_torch.examples.streaming_updates \\
        [--device cpu]

``run(device)`` returns the store's live edge set at the end beside the
numbers it prints.
"""
import argparse
import threading
import time

import torch

from repro_torch.analytics import materialize_csr, pagerank
from repro_torch.core import StoreConfig
from repro_torch.core.concurrent import ConcurrentLSMGraph
from repro_torch.data.graphgen import powerlaw_edges, update_stream

V = 1500


def run(device=None, log=print) -> set:
    cfg = StoreConfig(vmax=V, mem_edges=1 << 11, seg_size=8,
                      n_segments=1 << 11, hash_slots=1 << 12,
                      ovf_cap=1 << 12, batch_cap=512, l0_run_limit=3,
                      seg_target_edges=1 << 12)
    g = ConcurrentLSMGraph(cfg, device=device)
    dev = g.store.device
    src, dst = powerlaw_edges(V, 20000, seed=1)

    stop = threading.Event()
    pr_runs = []

    def analyst():
        """Long-running analytics on consistent snapshots while writes
        stream."""
        while not stop.is_set():
            snap = g.snapshot()
            view = materialize_csr(snap, V)
            pagerank(view, iters=5)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            pr_runs.append((snap.tau, view.n_edges))
            snap.release()
            time.sleep(0.05)

    t = threading.Thread(target=analyst, daemon=True)
    t.start()

    t0 = time.time()
    n = 0
    for op, s, d in update_stream(src, dst, delete_ratio=1 / 21):
        if op == "insert":
            g.insert_edges(s, d)
        else:
            g.delete_edges(s, d)
        n += len(s)
    g.flush()
    stop.set()
    t.join(timeout=5)
    dt = time.time() - t0

    log(f"streamed {n} updates in {dt:.2f}s ({n/dt:.0f} ops/s) "
        f"with {len(pr_runs)} concurrent PageRank runs")
    log(f"levels: {g.store.level_sizes()}")
    log("snapshot progression (tau, live edges):", pr_runs[:3], "...",
        pr_runs[-2:] if len(pr_runs) > 4 else "")
    with g.snapshot() as snap:
        edges = snap.edge_set()
    g.close()
    return edges


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the store (default: the current CUDA "
                         "card)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
