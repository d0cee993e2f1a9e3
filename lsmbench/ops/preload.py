"""Set-up of the cells that read a store: the whole stream ingested into
a deployment by the program's own ingest, with no final flush, so the
MemGraph and every level the stream reaches stay live."""
from __future__ import annotations

import time

from ..deploy import Deployment
from .common import apply


def preload(run) -> Deployment:
    dep = Deployment(run.config["store"], run.device)
    host = run.host
    t0 = time.perf_counter()
    for lo, hi, ins in host.batches:
        apply(dep.store, host, lo, hi, ins)
    runs = [[len(lvl) for lvl in sh.levels] for sh in dep.shards]
    run.log(f"preload: {len(host.src)} records in "
            f"{time.perf_counter() - t0:.3f} s; runs by level "
            f"{runs}; MemGraph records "
            f"{[sh.n_edges_cached() for sh in dep.shards]}")
    return dep
