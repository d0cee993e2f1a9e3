"""Closed-loop readers on a store that holds the whole stream: each client
repeats ``snapshot()``, ``neighbors_batch`` of a set of distinct vertices
with props, ``release()``.  The vertex sets are drawn from the seed in
set-up, uniformly among the vertices with at least one live edge (either
end), a pool a client that it cycles through.

Set-up ingests the whole stream with no final flush, so the MemGraph and
the levels it reaches are all live, then makes two rounds of concurrent
reads, one a client, so that the spine of the sealed runs is built and the
allocator holds what concurrent reads take before the window.

Check: a sample of each client's completed requests, drawn from the seed,
held to the last-writer-wins adjacency of the whole stream.
"""
from __future__ import annotations

import threading
import time

import numpy as np

from ..reference import adjacency_of, lww_csr
from ..trace import span
from .common import Sample, compare_lists, draw_vertices, flatten, free
from .preload import preload


class Op:
    def __init__(self, run) -> None:
        self.run = run
        w = run.workload
        self.samples = [Sample(w["check"]["requests_per_client"], run.seed, i)
                        for i in range(w["clients"])]

    def setup(self) -> None:
        run, w = self.run, self.run.workload
        self.dep = preload(run)
        self.pools = [draw_vertices(run.stream.live_any,
                                    w["vertices"], w["pool"], run.seed,
                                    f"read{i}")
                      for i in range(w["clients"])]
        # Two rounds of concurrent reads, as the window makes them: the
        # allocator then holds what concurrent resolves take.
        for _ in range(2):
            threads = [threading.Thread(target=self._read, args=(pool[-1],))
                       for pool in self.pools]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

    def _read(self, vs):
        snap = self.dep.store.snapshot()
        try:
            return snap.neighbors_batch(vs, return_props=True)
        finally:
            snap.release()

    def client(self, i: int, sl) -> None:
        run, pool, sample = self.run, self.pools[i], self.samples[i]
        n = 0
        try:
            while True:
                now = time.perf_counter()
                if sl is not None:
                    sl.tick(now)
                if now >= run.deadline:
                    break
                vs = pool[n % len(pool)]
                n += 1
                t0 = time.perf_counter()
                try:
                    # The read ends in copies of its answer to the host.
                    with span(run.spans, "read.request", sync=False):
                        out = self._read(vs)
                except Exception as e:
                    run.record("read", t0, time.perf_counter(), len(vs),
                               False, e)
                    continue
                run.record("read", t0, time.perf_counter(), len(vs), True)
                sample.offer((vs, out))
        finally:
            if sl is not None:
                sl.close()

    def close(self) -> None:
        free(getattr(self, "dep", None))
        self.dep = None

    def check(self):
        run, s = self.run, self.run.stream
        self.close()
        kept = [item for smp in self.samples for item in smp.kept]
        vs = np.concatenate([v for v, _ in kept] + [np.zeros(0, np.int64)])
        got = flatten([pair for _, out in kept for pair in out])
        ref = lww_csr(s.src, s.dst, s.ins, s.prop,
                      int(run.config["store"]["config"]["vmax"]))
        run.log(f"check: {len(kept)} requests of "
                f"{sum(smp.seen for smp in self.samples)} completed, "
                f"{len(vs)} adjacency lists, {len(got[1])} edges")
        return compare_lists(got, adjacency_of(ref, vs))
