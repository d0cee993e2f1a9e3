"""Fig 14: disk space cost after full ingest, per system (+ index variants)
(the port of ``benchmarks/bench_space.py``)."""
from __future__ import annotations

import numpy as np

from ..core.index import CompactIndex, index_nbytes_dense
from .common import (cli_device, emit, graph_edges, make_systems, scale,
                     suite_device)


def run(device=None) -> list:
    dev = suite_device(device)
    V = scale().V
    src, dst = graph_edges(seed=2)
    rows = []
    for name, sys_ in make_systems(dev).items():
        sys_.insert_edges(src, dst)
        sys_.delete_edges(src[:1000], dst[:1000])
        rows.append((f"fig14_space_{name}", 0.0,
                     f"bytes={sys_.disk_bytes()}"))
    # index variants (paper Fig 8 page-set compression vs dense)
    dense = index_nbytes_dense(V, 5)
    ci = CompactIndex(V)
    rng = np.random.default_rng(0)
    for v in rng.integers(0, V, 2000):
        ci.set_position(int(v), int(rng.integers(1, 5)),
                        int(rng.integers(0, 100)), int(rng.integers(0, 4096)))
    rows.append(("fig14_index_dense", 0.0, f"bytes={dense}"))
    rows.append(("fig14_index_compact", 0.0, f"bytes={ci.nbytes()}"))
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
