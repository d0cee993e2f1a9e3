"""Distributed LSMGraph: vertex-sharded analytics and update routing over a
``torch.distributed`` mesh (port of ``repro.core.distributed``).

* Vertices are RANGE-partitioned over the mesh's ``data`` axis
  (``partition_csr``, on the host, arrays byte-equal to the reference's);
  each rank places its own shard on its device.
* Distributed PageRank iterates locally and exchanges the dense iterate
  with one all-gather a sweep (``exchange`` fp32, bf16 or int8 with a
  shared max scale).  The shard-local reduce is the port's ``gather_segsum``
  kernel (``kernels.segment_reduce``).
* Update ingestion routes edge batches to their owner shard with a bucketed
  all-to-all (padded, ragged-safe): ``route_updates_local`` and
  ``route_edge_batches_local`` for one rank's batch, ``make_route_updates``
  and ``make_route_edge_batches`` as callables bound to a mesh.

Where the reference runs one ``shard_map`` program over every shard, the
port runs one process a shard: each function here is called by every rank
of the mesh with its own inputs, and the mesh's collectives join them
(``launch.mesh``; a CUDA tensor over gloo is staged through the host).

Two departures from the reference, both where it is wrong or where torch
differs:

* **Pad vertices (the reference's fault 6).**  ``partition_csr`` rounds the
  shard width up, so with ``n_vertices % n_shards != 0`` the last shard
  holds pad vertices of degree 0.  The reference starts them at ``1/n`` and
  counts them as dangling, so their mass leaks into every real vertex.
  Here a pad vertex starts at 0, stays 0 and is never dangling: the result
  equals the single-store PageRank for any shard count.
* **Out-of-range scatters.**  XLA drops a scatter outside its buffer; torch
  raises, so the bucket scatter is masked explicitly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Protocol, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import segment_reduce

_F32 = torch.float32
_I32 = torch.int32
EXCHANGES = ("fp32", "bf16", "int8")


class Mesh(Protocol):
    """What this module needs of a mesh (``launch.mesh.ShardMesh`` is
    one): this rank, its device, the shape, and the collectives."""

    rank: int
    device: torch.device
    shape: Tuple[int, ...]

    def all_gather(self, t: torch.Tensor, axis: str = ...) -> torch.Tensor:
        ...

    def all_reduce(self, t: torch.Tensor, op,
                   axis: str = ...) -> torch.Tensor:
        ...

    def all_to_all(self, t: torch.Tensor, axis: str = ...) -> torch.Tensor:
        ...


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


class LocalShard(NamedTuple):
    """One rank's shard on its device: its edges (the stacked layout's pads
    cut), ``seg_id`` local to the shard, and its vertices' out-degrees."""

    dst: torch.Tensor     # int32[E]   global destination ids
    seg_id: torch.Tensor  # int32[E]   source id - v_start, non-decreasing
    wt: torch.Tensor      # float32[E]
    deg: torch.Tensor     # float32[Vl]
    real: torch.Tensor    # bool[Vl]   v_start + i < n_vertices
    v_start: int
    n_vertices: int
    n_shards: int

    @property
    def v_local(self) -> int:
        return self.deg.shape[0]


class ShardedCSR(NamedTuple):
    """Stacked per-shard CSR (leading axis = shards), on the host."""

    dst: np.ndarray      # int32[S, Emax]
    seg: np.ndarray      # int32[S, Emax]  — GLOBAL source vertex id
    wt: np.ndarray       # float32[S, Emax] (0 = pad)
    deg: np.ndarray      # float32[S, Vl]  — local out-degrees
    v_start: np.ndarray  # int32[S]
    n_vertices: int
    n_shards: int

    @property
    def v_local(self) -> int:
        return self.deg.shape[1]

    def local(self, rank: int, device) -> LocalShard:
        """Shard ``rank`` on ``device``.  The pads at the tail of its rows
        (``wt == 0``, ``seg == 0``, which the reference masks in its
        reduce) are not placed: the kernel needs ``seg_id`` that does not
        decrease, and a pad's 0 after the real edges would break that."""
        n_e = int(np.count_nonzero(self.wt[rank]))
        v0, vl = int(self.v_start[rank]), self.v_local

        def put(a):  # a copy: the rows may be a read-only memory map
            return torch.from_numpy(np.array(a)).to(device)
        return LocalShard(
            dst=put(self.dst[rank, :n_e]),
            seg_id=put(self.seg[rank, :n_e] - np.int32(v0)),
            wt=put(self.wt[rank, :n_e]), deg=put(self.deg[rank]),
            real=put(v0 + np.arange(vl) < self.n_vertices),
            v_start=v0, n_vertices=self.n_vertices, n_shards=self.n_shards)


def partition_csr(view, n_shards: int) -> ShardedCSR:
    """Range-partition a CSRView (tensors or arrays) into stacked
    shard-local arrays (host)."""
    v = view.n_vertices
    vl = (v + n_shards - 1) // n_shards
    voff = _np(view.voff)
    dst = _np(view.dst)
    seg = _np(view.seg_ids())
    emax = 1
    pieces = []
    for s in range(n_shards):
        lo_v, hi_v = min(s * vl, v), min((s + 1) * vl, v)
        lo_e, hi_e = int(voff[lo_v]), int(voff[hi_v])
        pieces.append((s * vl, dst[lo_e:hi_e], seg[lo_e:hi_e],
                       voff[lo_v + 1:hi_v + 1] - voff[lo_v:hi_v]))
        emax = max(emax, hi_e - lo_e)
    S = n_shards
    out_dst = np.zeros((S, emax), np.int32)
    out_seg = np.zeros((S, emax), np.int32)
    out_wt = np.zeros((S, emax), np.float32)
    out_deg = np.zeros((S, vl), np.float32)
    v_start = np.zeros((S,), np.int32)
    for s, (lo_v, d, g, degs) in enumerate(pieces):
        n = len(d)
        out_dst[s, :n] = d
        out_seg[s, :n] = g
        out_wt[s, :n] = 1.0
        out_deg[s, :len(degs)] = degs
        v_start[s] = lo_v
    return ShardedCSR(dst=out_dst, seg=out_seg, wt=out_wt, deg=out_deg,
                      v_start=v_start, n_vertices=v, n_shards=n_shards)


def _check_mesh(mesh: Mesh, n_shards: int) -> None:
    size = int(np.prod(mesh.shape))
    if size != n_shards:
        raise ValueError(f"a mesh of {size} ranks for {n_shards} shards")


def _local_segsum(dst, seg_id, wt, x_full, vl: int) -> torch.Tensor:
    """Shard-local CSR reduce: y_local[u - v_start] over the shard's edges,
    by the ``gather_segsum`` kernel on CUDA tensors (its plain version on
    CPU tensors)."""
    return segment_reduce.gather_segsum(dst, seg_id, wt, x_full, n_out=vl)


def pagerank_step(shard: LocalShard, x_local: torch.Tensor, *,
                  mesh: Mesh, axis: str = "data", damping: float = 0.85,
                  exchange: str = "fp32") -> torch.Tensor:
    """One PR sweep of this rank's shard; every rank of ``mesh`` calls it.

    `exchange` compresses the dense-iterate all-gather (the only
    cross-shard traffic):
      fp32 — baseline; bf16 — 2x fewer bytes; int8 — 4x, shared max scale
      (quantization error bounded by |c|_max/127 per sweep).
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"exchange must be one of {EXCHANGES}, not "
                         f"{exchange!r}")
    contrib_local = x_local / shard.deg.clamp(min=1.0)
    if exchange == "bf16":
        contrib_full = mesh.all_gather(contrib_local.to(torch.bfloat16),
                                       axis).to(_F32)
    elif exchange == "int8":
        amax = mesh.all_reduce(contrib_local.abs().max(), dist.ReduceOp.MAX,
                               axis)
        scale = amax.clamp(min=1e-30) / 127.0
        q = torch.clamp(torch.round(contrib_local / scale), -127, 127
                        ).to(torch.int8)
        contrib_full = mesh.all_gather(q, axis).to(_F32) * scale
    else:
        contrib_full = mesh.all_gather(contrib_local, axis)
    y = _local_segsum(shard.dst, shard.seg_id, shard.wt, contrib_full,
                      shard.v_local)
    dangling_v = (shard.deg == 0) & shard.real
    dang_local = torch.where(dangling_v, x_local, 0.0).sum()
    dangling = mesh.all_reduce(dang_local, dist.ReduceOp.SUM, axis)
    n = shard.n_vertices
    x = (1.0 - damping) / n + damping * (y + dangling / n)
    return torch.where(shard.real, x, 0.0)


def make_distributed_pagerank(mesh: Mesh, shard: ShardedCSR, *,
                              axis: str = "data", iters: int = 20,
                              damping: float = 0.85,
                              exchange: str = "fp32") -> Callable:
    """Distributed PageRank over ``mesh``; every rank calls it with the same
    ``shard`` and places its own slice on ``mesh.device`` now.

    The returned ``run()`` iterates ``iters`` sweeps (a host loop, every
    rank calling it) and returns the whole iterate, float32[S * v_local]
    in vertex order with the pad vertices 0, on every rank: one more
    all-gather, so that each rank holds what the reference's ``run()``
    returns."""
    _check_mesh(mesh, shard.n_shards)
    local = shard.local(mesh.rank, mesh.device)
    n = shard.n_vertices

    def run() -> torch.Tensor:
        x = torch.where(local.real, 1.0 / n, 0.0).to(_F32)
        for _ in range(iters):
            x = pagerank_step(local, x, mesh=mesh, axis=axis,
                              damping=damping, exchange=exchange)
        return mesh.all_gather(x, axis)

    return run


# ---------------------------------------------------------------------------
# Update routing: the distributed ingest path.
# ---------------------------------------------------------------------------

def _bucket_exchange(src, channels: Sequence[torch.Tensor],
                     fills: Sequence, n_valid, *, v_local: int,
                     n_shards: int, bucket_cap: int, mesh: Mesh,
                     axis: str):
    """Shared bucketed all-to-all core: owner = src // v_local (range
    partition), stable bucket layout (sort by owner, rank within bucket),
    one exchange for every channel.  Returns (routed_src, routed_channels,
    valid, dropped) — every output padded to ``n_shards * bucket_cap``.

    A record whose owner is not one of the ``n_shards`` is not routed and
    not counted as dropped (as in the reference for sources past the last
    shard); ``dropped`` counts the records that found their bucket full."""
    dev = src.device
    bc = src.shape[0]
    pos = torch.arange(bc, dtype=_I32, device=dev)
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.reshape(()).to(dev)
    src = src.to(_I32)
    owner = torch.div(src, v_local, rounding_mode="floor")
    routed = (pos < n_valid) & (owner >= 0) & (owner < n_shards)
    owner = torch.where(routed, owner, n_shards)
    # Stable bucket layout: one stable sort by owner (pos ascends already).
    owner_s, order = torch.sort(owner, stable=True)
    first = torch.searchsorted(owner_s, owner_s, right=False)
    rank = pos - first.to(_I32)
    in_bucket = owner_s < n_shards
    keep = in_bucket & (rank < bucket_cap)
    dropped = (in_bucket & (rank >= bucket_cap)).sum().to(_I32)
    slot = (owner_s * bucket_cap + rank)[keep].long()
    take = order[keep]
    width = n_shards * bucket_cap
    cols = [src, *channels]
    # Every channel is 4 bytes a record: one int32 buffer [shard, channel,
    # slot] carries them all in one all-to-all.
    send = torch.empty((len(cols), width), dtype=_I32, device=dev)
    for i, (col, fill) in enumerate(zip(cols, [-1] + list(fills))):
        buf = torch.full((width,), fill, dtype=col.dtype, device=dev)
        buf[slot] = col[take]
        send[i] = buf.view(_I32)
    send = send.view(len(cols), n_shards, bucket_cap).transpose(0, 1)
    recv = mesh.all_to_all(send.reshape(-1), axis).view(
        n_shards, len(cols), bucket_cap).transpose(0, 1).reshape(
            len(cols), width)
    out = [recv[i].view(c.dtype) for i, c in enumerate(cols)]
    return out[0], tuple(out[1:]), (out[0] >= 0).to(_I32), dropped


def route_updates_local(src, dst, prop, n_valid, *, v_local: int,
                        n_shards: int, bucket_cap: int, mesh: Mesh,
                        axis: str = "data"):
    """Route this rank's pending updates to their owner shards; every rank
    of ``mesh`` calls it.

    Returns (src, dst, prop, valid, dropped) of the updates this rank
    received, padded to n_shards * bucket_cap (int32, int32, float32,
    int32, and int32[1]).  Owner = src // v_local (range partition).
    """
    r_src, (r_dst, r_prop), r_valid, dropped = _bucket_exchange(
        src, (dst.to(_I32), prop.to(_F32)), (-1, 0.0), n_valid,
        v_local=v_local, n_shards=n_shards, bucket_cap=bucket_cap,
        mesh=mesh, axis=axis)
    return r_src, r_dst, r_prop, r_valid, dropped.reshape(1)


def route_edge_batches_local(src, dst, prop, marker, n_valid, *,
                             v_local: int, n_shards: int, bucket_cap: int,
                             mesh: Mesh, axis: str = "data"):
    """Route full ``EdgeBatch`` payloads (insert AND tombstone records) to
    owner shards — the sharded graph service's write dispatch.  The bucket
    and all-to-all of ``route_updates_local`` plus a marker channel (int32
    0/1: tombstones must reach the same owner shard as the inserts they
    annihilate).  Returns (src, dst, prop, marker, valid, dropped)."""
    r_src, (r_dst, r_prop, r_marker), r_valid, dropped = _bucket_exchange(
        src, (dst.to(_I32), prop.to(_F32), marker.to(_I32)), (-1, 0.0, 0),
        n_valid, v_local=v_local, n_shards=n_shards, bucket_cap=bucket_cap,
        mesh=mesh, axis=axis)
    return (r_src, r_dst, r_prop, r_marker, r_valid, dropped.reshape(1))


def make_route_updates(mesh: Mesh, *, v_local: int, n_shards: int,
                       batch_cap: int, bucket_cap: int, axis: str = "data"):
    """The update router over ``mesh``: ``route(src, dst, prop, n_valid)``
    takes this rank's batch of ``batch_cap`` slots (the first ``n_valid``
    in use) and returns ``route_updates_local``'s outputs."""
    _check_mesh(mesh, n_shards)

    def route(src, dst, prop, n_valid):
        if src.shape[0] != batch_cap:
            raise ValueError(f"a batch of {src.shape[0]} slots, not "
                             f"{batch_cap}")
        return route_updates_local(
            src, dst, prop, n_valid, v_local=v_local, n_shards=n_shards,
            bucket_cap=bucket_cap, mesh=mesh, axis=axis)

    return route


def make_route_edge_batches(mesh: Mesh, *, v_local: int, n_shards: int,
                            bucket_cap: int, axis: str = "data"):
    """The ``EdgeBatch`` router over ``mesh`` (the sharded service's write
    tier, marker channel included): ``route(src, dst, prop, marker,
    n_valid)`` on this rank's batch."""
    _check_mesh(mesh, n_shards)

    def route(src, dst, prop, marker, n_valid):
        return route_edge_batches_local(
            src, dst, prop, marker, n_valid, v_local=v_local,
            n_shards=n_shards, bucket_cap=bucket_cap, mesh=mesh, axis=axis)

    return route


__all__ = ["ShardedCSR", "LocalShard", "partition_csr", "pagerank_step",
           "make_distributed_pagerank", "route_updates_local",
           "route_edge_batches_local", "make_route_updates",
           "make_route_edge_batches", "EXCHANGES"]
