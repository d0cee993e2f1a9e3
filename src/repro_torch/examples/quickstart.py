"""Quickstart: LSMGraph in 40 lines — ingest, delete, snapshot, analyze
(the port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.analytics import bfs, materialize_csr, pagerank
from repro_torch.core import LSMGraph, StoreConfig

V = 1000


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of the store (default: the current CUDA "
                         "card)")
    args = ap.parse_args(argv)
    cfg = StoreConfig(vmax=V, mem_edges=1 << 10, seg_size=4,
                      n_segments=1 << 10, hash_slots=1 << 11,
                      ovf_cap=1 << 11, batch_cap=256, l0_run_limit=2,
                      seg_target_edges=1 << 12)
    store = LSMGraph(cfg, device=args.device)

    # Ingest a ring + random chords (undirected).
    rng = np.random.default_rng(0)
    ring = np.arange(V)
    store.insert_edges(np.r_[ring, (ring + 1) % V],
                       np.r_[(ring + 1) % V, ring],
                       prop=np.ones(2 * V, np.float32))
    u = rng.integers(0, V, 3000)
    w = rng.integers(0, V, 3000)
    store.insert_edges(np.r_[u, w], np.r_[w, u])

    # Delete a few chords again — tombstones, resolved at read & compaction.
    store.delete_edges(np.r_[u[:100], w[:100]], np.r_[w[:100], u[:100]])

    with store.snapshot() as snap:
        print("neighbors(0):", snap.neighbors(0)[:10])
        view = materialize_csr(snap, V)
        print(f"live edges: {view.n_edges}")
        pr = pagerank(view, iters=10)
        print("top PageRank:", np.argsort(-pr.cpu().numpy())[:5])
        dist = bfs(view, 0)
        print("BFS reached:", int((dist < 1e30).sum()), "vertices")

    print("level sizes:", store.level_sizes())
    print("io counters:", store.io)


if __name__ == "__main__":
    main()
