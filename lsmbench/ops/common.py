"""What the client loops share: writing a stream's calls into a
deployment, reading adjacency lists back, holding them to the reference,
the warm-up, and the sample of requests kept for the check."""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..data import generator, make_stream, sub_seed
from ..deploy import Deployment


@dataclass
class Check:
    """One number compared, with its limit: the run is correct only where
    ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def apply(store, host, lo: int, hi: int, insert: bool) -> None:
    """One writer call: records ``[lo, hi)`` of the stream."""
    if insert:
        store.insert_edges(host.src[lo:hi], host.dst[lo:hi], host.prop[lo:hi])
    else:
        store.delete_edges(host.src[lo:hi], host.dst[lo:hi])


def flatten(lists):
    """A list of (dst, prop) arrays as (offsets, dst, prop) laid end to
    end."""
    offs = np.zeros(len(lists) + 1, np.int64)
    offs[1:] = np.cumsum([len(d) for d, _ in lists])
    if not lists:
        return offs, np.zeros(0, np.int32), np.zeros(0, np.float32)
    return (offs, np.concatenate([d for d, _ in lists]).astype(np.int32),
            np.concatenate([p for _, p in lists]).astype(np.float32))


def read_back(store, vertices: np.ndarray):
    """The adjacency lists of ``vertices`` with props through one snapshot
    of the store, laid end to end."""
    snap = store.snapshot()
    try:
        return flatten(snap.neighbors_batch(vertices, return_props=True))
    finally:
        snap.release()


def compare_lists(got, want) -> List[Check]:
    """Vertices whose adjacency (dst) differs from the reference's, and
    edges of the other vertices whose prop differs in any bit.  Both are
    exact comparisons: the limit is 0."""
    g_offs, g_dst, g_prop = (np.asarray(x) for x in got)
    w_offs, w_dst, w_prop = (np.asarray(x) for x in want)
    g_deg, w_deg = np.diff(g_offs), np.diff(w_offs)
    same_deg = g_deg == w_deg
    # Edge positions of the vertices whose degrees agree, on both sides.
    v = np.flatnonzero(same_deg)
    deg = w_deg[v]
    start = np.repeat(np.cumsum(deg) - deg, deg)
    k = np.arange(int(deg.sum())) - start
    gi = np.repeat(g_offs[v], deg) + k
    wi = np.repeat(w_offs[v], deg) + k
    owner = np.repeat(np.arange(len(v)), deg)
    dst_bad = g_dst[gi].astype(np.int64) != w_dst[wi].astype(np.int64)
    bad_v = np.zeros(len(v), bool)
    np.logical_or.at(bad_v, owner[dst_bad], True)
    lists = int((~same_deg).sum() + bad_v.sum())
    good_edge = ~bad_v[owner]
    props = int((g_prop[gi][good_edge].view(np.uint32)
                 != w_prop[wi][good_edge].view(np.uint32)).sum())
    return [Check("lists_differing", lists, 0),
            Check("props_differing", props, 0)]


def free(dep) -> None:
    """Close a deployment and hand its memory back."""
    if dep is not None:
        dep.close()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def warm_up(run) -> None:
    """Run the configuration's code paths once at the warm-up's small
    size, so that the window loads no kernel: ingest of a small stream
    through flushes and compactions into the deepest levels it reaches,
    then a read of every vertex it touched."""
    w = run.workload["warmup"]
    cfg = {**run.config, "graph": {**run.config["graph"], **w["graph"]},
           "stream": {**run.config["stream"], **w["stream"]}}
    stream = make_stream(cfg, run.seed, run.device)
    host = stream.host()
    dep = Deployment(run.config["store"], run.device, **w["store"])
    try:
        for lo, hi, ins in host.batches:
            apply(dep.store, host, lo, hi, ins)
        read_back(dep.store, np.unique(host.src).astype(np.int64))
    finally:
        free(dep)


class Sample:
    """A reservoir of ``size`` requests, drawn from the seed, among those
    one client completed."""

    def __init__(self, size: int, seed: int, client: int) -> None:
        self.size = size
        self.rng = np.random.default_rng(sub_seed(seed, f"sample{client}"))
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept[j] = item


def draw_vertices(pool: torch.Tensor, n: int, count: int, seed: int,
                  purpose: str) -> List[np.ndarray]:
    """``count`` requests of ``n`` distinct vertices each, drawn uniformly
    from ``pool``, on the host."""
    g = generator(seed, purpose, pool.device)
    out = []
    for _ in range(count):
        idx = torch.randperm(pool.shape[0], generator=g,
                             device=pool.device)[:n]
        out.append(pool[idx].cpu().numpy().astype(np.int64))
    return out
