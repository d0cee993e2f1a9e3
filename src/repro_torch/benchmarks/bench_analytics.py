"""Fig 12 (runtime) + Fig 13 (I/O amount): SSSP / BFS / CC / SCAN (+PR) on
every system, after a mixed-update ingest (the port of
``benchmarks/bench_analytics.py``).  The cross-system metric is the
bytes-moved I/O proxy + wall time.  Every system's CSR becomes a
``CSRView`` of tensors on the device, so every algorithm runs the segment
kernels there."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..analytics import (bfs, cc, materialize_csr, pagerank, scan_stats,
                         sssp)
from ..analytics.view import CSRView
from .common import (cli_device, emit, graph_edges, io_read, make_systems,
                     scale, suite_device, sync)


def _view_from_baseline(sys_, n_vertices: int, dev) -> CSRView:
    voff, dst, prop = sys_.snapshot_csr()
    return CSRView(voff=torch.as_tensor(voff, device=dev),
                   dst=torch.as_tensor(dst, device=dev),
                   prop=torch.as_tensor(np.maximum(prop, 0.01), device=dev),
                   n_vertices=n_vertices, n_edges=int(voff[-1]))


def ingest(dev):
    """Every system after the suite's mixed-update ingest, and the source
    of the traversals."""
    src, dst = graph_edges(seed=1)
    systems = make_systems(dev)
    for sys_ in systems.values():
        sys_.insert_edges(np.r_[src, dst], np.r_[dst, src])
        sys_.delete_edges(np.r_[src[:500], dst[:500]],
                          np.r_[dst[:500], src[:500]])
    return systems, int(src[0])


def algorithms(source: int, use_pallas: bool = True) -> dict:
    """The figure's algorithms over a view; ``use_pallas=False`` runs the
    segment kernels' plain versions."""
    return {
        "sssp": lambda v: sssp(v, source, use_pallas=use_pallas),
        "bfs": lambda v: bfs(v, source, use_pallas=use_pallas),
        "cc": lambda v: cc(v, use_pallas=use_pallas),
        "scan": lambda v: scan_stats(v, use_pallas=use_pallas),
        "pagerank": lambda v: pagerank(v, iters=10, use_pallas=use_pallas),
    }


def run(device=None) -> list:
    dev = suite_device(device)
    V = scale().V
    rows: list = []
    systems, source = ingest(dev)
    algos = algorithms(source)
    for name, sys_ in systems.items():
        for aname, fn in algos.items():
            sync(dev)
            r0 = io_read(sys_)
            t0 = time.perf_counter()
            if name == "lsmgraph":
                snap = sys_.snapshot()
                view = materialize_csr(snap, V)
                fn(view)
                sync(dev)
                snap.release()
            else:
                view = _view_from_baseline(sys_, V, dev)
                fn(view)
                sync(dev)
            dt = time.perf_counter() - t0
            rows.append((f"fig12_{aname}_{name}", dt * 1e6,
                         f"io_bytes={io_read(sys_) - r0}"))
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
