"""One closed-loop analytics client on an unchanged store that holds the
whole stream: each request takes a snapshot, materializes its CSR, runs
PageRank, then BFS and SSSP from the next of the search keys, copies the
three results to the host and releases the snapshot.  The search keys
are drawn from the seed in set-up, uniformly among the vertices that a
live edge points to (a search follows stored edges towards its key).

Set-up ingests the whole stream as the read cell does and runs as many
requests as the check keeps, and one more, holding their results.

Check: a sample of the completed requests, drawn from the seed: the CSR
each materialized against the last-writer-wins CSR of the stream
(adjacency exact, props to the bit), PageRank against the reference's in
float64 (relative L1), BFS exact, SSSP's reachable set exact and its
distances against the reference's Bellman-Ford in float64 (largest
absolute error).
"""
from __future__ import annotations

import time

import torch

from ..data import generator
from ..reference import lww_csr
from ..reference import algorithms as ref_alg
from ..trace import span
from .common import Check, Sample, free
from .preload import preload


class Op:
    def __init__(self, run) -> None:
        self.run = run
        self.sample = Sample(run.workload["check"]["requests"], run.seed, 0)

    def setup(self) -> None:
        run, w = self.run, self.run.workload
        self.dep = preload(run)
        pool = run.stream.live_in
        g = generator(run.seed, "search_keys", pool.device)
        self.keys = pool[torch.randint(pool.shape[0], (w["search_keys"],),
                                       generator=g, device=pool.device)
                         ].tolist()
        # As many requests as the check keeps, and one more, held together:
        # the allocator then holds what the window's kept requests take.
        held = [self._request(self.keys[-1 - i])
                for i in range(w["check"]["requests"] + 1)]
        del held

    def _request(self, key: int):
        from repro_torch.analytics import bfs, materialize_csr, pagerank, sssp
        run, spans = self.run, self.run.spans
        # The layer spans end in a synchronize only where the per-layer
        # metrics read them; the request itself ends in the copies to the
        # host.
        sync = run.trace
        n = int(run.config["store"]["config"]["vmax"])
        snap = self.dep.store.snapshot()
        try:
            with span(spans, "analytics.materialize_csr", sync=sync):
                view = materialize_csr(snap, n)
            with span(spans, "analytics.pagerank", sync=sync):
                pr = pagerank(view, iters=run.workload["pagerank_iters"])
            with span(spans, "analytics.bfs", sync=sync):
                hops = bfs(view, key)
            with span(spans, "analytics.sssp", sync=sync):
                dist = sssp(view, key)
            with span(spans, "analytics.to_host", sync=False):
                out = (pr.cpu(), hops.cpu(), dist.cpu())
        finally:
            snap.release()
        run.info["segment_view"] = (view.n_edges, view.n_vertices)
        return view, key, out

    def client(self, i: int, sl) -> None:
        run = self.run
        n = 0
        try:
            while True:
                now = time.perf_counter()
                if sl is not None:
                    sl.tick(now)
                if now >= run.deadline:
                    break
                key = self.keys[n % len(self.keys)]
                n += 1
                t0 = time.perf_counter()
                try:
                    with span(run.spans, "analytics.request", sync=False):
                        result = self._request(key)
                except Exception as e:
                    run.record("analytics", t0, time.perf_counter(), 1,
                               False, e)
                    continue
                run.record("analytics", t0, time.perf_counter(), 1, True)
                self.sample.offer(result)
        finally:
            if sl is not None:
                sl.close()

    def close(self) -> None:
        free(getattr(self, "dep", None))
        self.dep = None

    def check(self):
        run, s = self.run, self.run.stream
        self.close()
        n = int(run.config["store"]["config"]["vmax"])
        voff, dst, prop = lww_csr(s.src, s.dst, s.ins, s.prop, n)
        pr_ref = ref_alg.pagerank(voff, dst, run.workload["pagerank_iters"])
        worst = dict(lists_differing=0, props_differing=0,
                     pagerank_rel_l1=0.0, bfs_differing=0,
                     sssp_reach_differing=0, sssp_max_abs_err=0.0)
        for view, key, (pr, hops, dist) in self.sample.kept:
            got = judge(view, pr, hops, dist, key, voff, dst, prop, pr_ref)
            for k, v in got.items():
                worst[k] = max(worst[k], v)
        limits = run.workload["limits"]
        run.log(f"check: {len(self.sample.kept)} requests of "
                f"{self.sample.seen} completed; {int(dst.shape[0])} live "
                f"edges")
        return [Check(k, v, limits.get(k, 0)) for k, v in worst.items()]


def judge(view, pr, hops, dist, key, voff, dst, prop, pr_ref) -> dict:
    """The numbers compared for one request against the reference CSR
    (``voff``, ``dst``, ``prop``) and its float64 PageRank."""
    dev = voff.device
    g_voff = view.voff.to(dev).long()
    g_deg, w_deg = g_voff[1:] - g_voff[:-1], voff[1:] - voff[:-1]
    same = g_deg == w_deg
    lists = int((~same).sum())
    props = 0
    if lists == 0 and view.dst.shape[0] == dst.shape[0]:
        d_bad = view.dst.to(dev) != dst
        p_bad = (view.prop.to(dev).view(torch.int32)
                 != prop.view(torch.int32))
        src = torch.repeat_interleave(torch.arange(len(w_deg), device=dev),
                                      w_deg)
        bad_v = torch.zeros(len(w_deg), dtype=torch.bool, device=dev)
        bad_v[src[d_bad]] = True
        lists = int(bad_v.sum())
        props = int((p_bad & ~bad_v[src]).sum())
    pr64 = pr.to(dev, torch.float64)
    rel = float((pr64 - pr_ref).abs().sum() / pr_ref.abs().sum())
    hops_ref = ref_alg.bfs_hops(voff, dst, key)
    bfs_bad = int((hops.to(dev) != hops_ref).sum())
    d_ref = ref_alg.sssp(voff, dst, prop, key)
    reach_ref = torch.isfinite(d_ref)
    d = dist.to(dev, torch.float64)
    reach = d < 1e38
    err = (d - d_ref).abs()[reach & reach_ref]
    return dict(lists_differing=lists, props_differing=props,
                pagerank_rel_l1=rel, bfs_differing=bfs_bad,
                sssp_reach_differing=int((reach != reach_ref).sum()),
                sssp_max_abs_err=float(err.max()) if err.numel() else 0.0)
