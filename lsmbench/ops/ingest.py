"""One writer, closed loop: the stream's calls in order into a fresh
deployment; when the stream runs out, a fresh deployment takes the stream
again from its start, inside the window.  The deployment that took the
whole stream is kept until the next one does, so the check can read it.

Check: each deployment's acknowledged records read back through one
snapshot (a sample of the vertices they touch, drawn from the seed, and
the sources of a sample of their deletes), held to the last-writer-wins
adjacency of those records: the current pass's prefix, and the whole
stream in the last deployment that took all of it (its flushes and its
compactions into the deepest levels).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..data import generator
from ..deploy import Deployment
from ..reference import adjacency_of, lww_csr
from ..trace import span
from .common import apply, compare_lists, free, read_back, warm_up


class Op:
    def __init__(self, run) -> None:
        self.run = run
        self.dep = None
        self.whole = None         # the last deployment that took it all
        self.pos = 0              # next call of the stream
        self.pass_records = 0     # records acknowledged in this pass
        self.passes = 0

    def _deploy(self) -> Deployment:
        return Deployment(self.run.config["store"], self.run.device)

    def setup(self) -> None:
        run = self.run
        warm_up(run)
        # The first calls at full size, and the flush they reach, into a
        # deployment that is then dropped.
        dep = self._deploy()
        try:
            for lo, hi, ins in run.host.batches[
                    :run.workload["warmup"]["full_size_calls"]]:
                apply(dep.store, run.host, lo, hi, ins)
        finally:
            free(dep)
        self.dep = self._deploy()

    def client(self, i: int, sl) -> None:
        run, host = self.run, self.run.host
        batches = host.batches
        try:
            while True:
                now = time.perf_counter()
                if sl is not None:
                    sl.tick(now)
                if now >= run.deadline:
                    break
                if self.pos == len(batches):
                    run.log(f"ingest: pass {self.passes + 1} ended "
                            f"{now - run.deadline + run.seconds:.3f} s "
                            f"into the window")
                    with span(run.spans, "ingest.restart", sync=False):
                        free(self.whole)
                        self.whole, self.dep = self.dep, self._deploy()
                    self.pos = self.pass_records = 0
                    self.passes += 1
                lo, hi, ins = batches[self.pos]
                t0 = time.perf_counter()
                try:
                    # The call returns once the store holds the records
                    # (its last step copies a flag to the host).
                    with span(run.spans, "ingest.call", sync=False):
                        apply(self.dep.store, host, lo, hi, ins)
                except Exception as e:
                    run.record("ingest", t0, time.perf_counter(), hi - lo,
                               False, e)
                    return
                run.record("ingest", t0, time.perf_counter(), hi - lo, True)
                self.pos += 1
                self.pass_records = hi
        finally:
            if sl is not None:
                sl.close()

    def close(self) -> None:
        free(self.dep)
        free(self.whole)
        self.dep = self.whole = None

    def _vertices(self, k: int, purpose: str) -> np.ndarray:
        """A sample, drawn from the seed, of the sources of the stream's
        first ``k`` records, with the sources of a sample of its
        deletes."""
        run, s = self.run, self.run.stream
        w = run.workload["check"]
        g = generator(run.seed, purpose, run.device)
        srcs = torch.unique(s.src[:k])
        pick = srcs[torch.randperm(srcs.shape[0], generator=g,
                                   device=run.device)[:w["sources"]]]
        dels = torch.nonzero(~s.ins[:k]).flatten()
        dels = dels[torch.randperm(dels.shape[0], generator=g,
                                   device=run.device)[:w["deletes"]]]
        vs = torch.unique(torch.cat([pick, s.src[dels]])).cpu().numpy()
        return vs.astype(np.int64)

    def check(self):
        run, s = self.run, self.run.stream
        # (deployment, records it acknowledged, which pass, sample purpose)
        held = [(self.dep, self.pass_records, self.passes + 1, "check")]
        if self.whole is not None:
            held.append((self.whole, s.n_records, self.passes, "check_whole"))
        reads = []
        for dep, k, n, purpose in held:
            vs = self._vertices(k, purpose)
            reads.append((k, n, vs, read_back(dep.store, vs)))
        self.close()
        vmax = int(run.config["store"]["config"]["vmax"])
        totals = None
        for k, n, vs, got in reads:
            ref = lww_csr(s.src[:k], s.dst[:k], s.ins[:k], s.prop[:k], vmax)
            checks = compare_lists(got, adjacency_of(ref, vs))
            run.log(f"check: pass {n}, {k} records acknowledged in it: "
                    f"{len(vs)} vertices, {len(got[1])} edges read back; "
                    + ", ".join(f"{c.name} {c.value}" for c in checks))
            del ref
            if totals is None:
                totals = checks
            else:
                for t, c in zip(totals, checks):
                    t.value += c.value
        return totals
