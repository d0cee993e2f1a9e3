"""The benchmark's data: a Graph500 R-MAT edge list and its update stream,
made from the seed on the device with plain torch.

Graph500 Kernel 1 (graph500.org specification): SCALE bits a vertex id,
``edgefactor << SCALE`` edges, each edge drawn bit by bit with the
probabilities A, B, C (and 1 - A - B - C) of the four quadrants, the
vertex ids then relabelled by one random permutation.  Kernel 3's weights
are uniform in [0, 1).  The store holds each edge at most once (a second
insert of a deleted edge would meet the store's compaction fault, which
resurrects it), so the list is the first ``n_edges`` distinct (src, dst)
pairs in generation order.

The stream is the paper's 20:1 insert:delete mix, as the port's
``data.update_stream`` makes it: runs of ``chunk`` inserts, each run from
the second on followed by ``int(chunk * delete_ratio)`` deletes drawn
uniformly, with replacement, among every edge inserted so far.  A pick of
an edge that an earlier pick already deleted is dropped, so every edge is
inserted once and deleted at most once.

Same seed, same device: same stream.  Nothing here imports the program.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, purpose))
    return g


def _first_distinct(key: torch.Tensor) -> torch.Tensor:
    """Indices of the first occurrence of each distinct key, ascending."""
    sk, order = torch.sort(key, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    return torch.sort(order[first]).values


def rmat_edges(graph: dict, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """(src int64, dst int64, weight float32) of the graph's first
    ``n_edges`` distinct R-MAT edges, in generation order, relabelled."""
    scale, n_edges = int(graph["scale"]), int(graph["n_edges"])
    a, b, c = (float(graph[k]) for k in ("a", "b", "c"))
    g = generator(seed, "rmat", device)
    draw = int(n_edges * 1.06) + 1024
    src_parts: List[torch.Tensor] = []
    dst_parts: List[torch.Tensor] = []
    while True:
        s = torch.zeros(draw, dtype=torch.int64, device=device)
        d = torch.zeros(draw, dtype=torch.int64, device=device)
        for _ in range(scale):
            r = torch.rand(draw, generator=g, device=device,
                           dtype=torch.float64)
            s = (s << 1) | (r > a + b)
            d = (d << 1) | (((r > a) & (r <= a + b)) | (r > a + b + c))
        src_parts.append(s)
        dst_parts.append(d)
        src, dst = torch.cat(src_parts), torch.cat(dst_parts)
        first = _first_distinct((src << scale) | dst)
        if first.shape[0] >= n_edges:
            break
        draw = n_edges - first.shape[0] + 1024
    first = first[:n_edges]
    perm = torch.randperm(1 << scale, generator=g, device=device)
    src, dst = perm[src[first]], perm[dst[first]]
    weight = torch.rand(n_edges, generator=g, device=device,
                        dtype=torch.float32)
    return src, dst, weight


@dataclass
class Stream:
    """An update stream: one record per insert or delete, in stream order,
    cut into the calls a writer makes (``batches``: (start, end, insert))."""

    src: torch.Tensor      # int32, on the device
    dst: torch.Tensor      # int32
    prop: torch.Tensor     # float32 (0 for a delete)
    ins: torch.Tensor      # bool
    batches: List[Tuple[int, int, bool]]
    n_inserts: int
    n_deletes: int
    picks_dropped: int
    live_any: torch.Tensor   # vertices with a live edge, either end
    live_in: torch.Tensor    # vertices with a live edge into them

    @property
    def n_records(self) -> int:
        return int(self.src.shape[0])

    def host(self) -> "HostStream":
        return HostStream(*(t.cpu().numpy() for t in (
            self.src, self.dst, self.prop, self.ins)), self.batches)


@dataclass
class HostStream:
    """The same stream as numpy arrays, what the store's API takes."""

    src: np.ndarray
    dst: np.ndarray
    prop: np.ndarray
    ins: np.ndarray
    batches: List[Tuple[int, int, bool]]


def update_stream(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
                  stream: dict, seed: int) -> Stream:
    """The 20:1 insert:delete stream over an edge list (see the module)."""
    device = src.device
    n = int(src.shape[0])
    chunk = int(stream["chunk"])
    ratio = float(stream["delete_ratio"])
    g = generator(seed, "deletes", device)
    runs = [(off, min(off + chunk, n)) for off in range(0, n, chunk)]
    # Delete picks after each run from the second on, uniform over the
    # edges inserted so far: one float64 draw a pick, scaled by its bound.
    counts = [int((hi - lo) * ratio) if hi > chunk else 0 for lo, hi in runs]
    n_picks = sum(counts)
    reps = torch.tensor(counts, dtype=torch.int64, device=device)
    run_of_pick = torch.repeat_interleave(
        torch.arange(len(runs), device=device), reps)
    ends = torch.tensor([hi for _, hi in runs], dtype=torch.int64,
                        device=device)
    bound = ends[run_of_pick]
    u = torch.rand(n_picks, generator=g, device=device, dtype=torch.float64)
    picks = torch.minimum((u * bound).long(), bound - 1)
    # Keep the first pick of each edge: a later one would delete it again.
    keep = torch.zeros(n_picks, dtype=torch.bool, device=device)
    if n_picks:
        keep[_first_distinct(picks)] = True
    kept_per_run = torch.zeros(len(runs), dtype=torch.int64, device=device)
    kept_per_run.index_add_(0, run_of_pick, keep.long())
    kept_per_run = kept_per_run.tolist()
    kept = picks[keep]

    idx_parts, batches = [], []
    pos = kpos = 0
    for (lo, hi), k in zip(runs, kept_per_run):
        idx_parts.append(torch.arange(lo, hi, device=device))
        batches.append((pos, pos + hi - lo, True))
        pos += hi - lo
        if k:
            idx_parts.append(kept[kpos:kpos + k])
            batches.append((pos, pos + k, False))
            pos += k
            kpos += k
    idx = torch.cat(idx_parts)
    ins = torch.cat([torch.full((hi - lo,), is_ins, dtype=torch.bool,
                                device=device)
                     for lo, hi, is_ins in batches])
    prop = torch.where(ins, weight[idx], torch.zeros((), device=device))
    live = torch.ones(n, dtype=torch.bool, device=device)
    live[kept] = False
    return Stream(src=src[idx].to(torch.int32), dst=dst[idx].to(torch.int32),
                  prop=prop.to(torch.float32), ins=ins, batches=batches,
                  n_inserts=n, n_deletes=int(kept.shape[0]),
                  picks_dropped=n_picks - int(kept.shape[0]),
                  live_any=torch.unique(torch.cat([src[live], dst[live]])),
                  live_in=torch.unique(dst[live]))


def make_stream(config: dict, seed: int, device) -> Stream:
    """The configuration's whole stream for ``seed``."""
    src, dst, weight = rmat_edges(config["graph"], seed, device)
    return update_stream(src, dst, weight, config["stream"], seed)
