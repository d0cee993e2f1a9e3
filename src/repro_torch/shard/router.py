"""Write and read routing for the sharded graph service.

The port of ``repro.shard.router``.  Its three tiers share the ownership
rule (``RangePartition``):

* **Write router** — ``bucket_edge_batches`` groups one ``(src, dst,
  prop)`` update batch by owner shard on the host (the single-process twin
  of the mesh write router below).  Deletes route by the
  same rule, so a tombstone reaches the shard of the insert it annihilates.

* **Read router** — ``route_queries`` splits a query vector by owner and
  remembers each query's caller-order position (``per_pos`` is the inverse
  permutation).  ``ShardedSnapshot`` assembles results without a scatter:
  ``query_edges_batch`` writes each shard's answers straight into the
  output at ``per_pos[s]``, and ``neighbors_batch`` routes the SORTED
  unique query vector as contiguous per-shard slices, so the gathered
  (offsets, dst, prop) triples concatenate back in order.

* **Mesh write router** — ``make_mesh_write_router`` is the same owner rule
  as a bucketed all-to-all between the ranks of a ``torch.distributed``
  mesh (``core.distributed.make_route_edge_batches``), with a marker
  channel, since one rank's batch may mix inserts and tombstones.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.distributed import make_route_edge_batches
from .partition import RangePartition


def bucket_edge_batches(part: RangePartition, src, dst, prop=None
                        ) -> List[Optional[Tuple[np.ndarray, np.ndarray,
                                                 Optional[np.ndarray]]]]:
    """Group one HOMOGENEOUS update batch (all inserts or all tombstones —
    the caller applies each bucket via ``insert_edges``/``delete_edges``)
    by owner shard.

    Returns a list over shards: ``(src, dst, prop)`` arrays per shard (prop
    is None iff no props were given), or None for shards receiving nothing.
    Raises on edges whose source lives on no shard (writes must land
    somewhere; reads merely return empty).
    """
    src = np.asarray(src, np.int64).ravel()
    dst = np.asarray(dst, np.int64).ravel()
    if prop is not None:
        prop = np.asarray(prop, np.float32).ravel()
    owner = part.owner_of(src)
    if (owner < 0).any():
        bad = src[owner < 0][:5]
        raise ValueError(
            f"edge sources outside the partition range [0, {part.vmax}): "
            f"{bad.tolist()} — no shard owns them")
    per_vids, per_pos = part.split_by_owner(src)
    out: List[Optional[Tuple]] = []
    for s_src, pos in zip(per_vids, per_pos):
        if len(pos) == 0:
            out.append(None)
            continue
        out.append((s_src, dst[pos], None if prop is None else prop[pos]))
    return out


def route_queries(part: RangePartition, vs
                  ) -> Tuple[List[np.ndarray], List[np.ndarray], int]:
    """Split a query vector by owner shard.

    Returns ``(per_shard_vs, per_shard_pos, n)``; positions index the
    original vector (duplicates allowed — every occurrence keeps its own
    slot, so duplicate query ids reassemble independently).
    """
    vs = np.asarray(vs, np.int64).ravel()
    per_vids, per_pos = part.split_by_owner(vs)
    return per_vids, per_pos, len(vs)


def make_mesh_write_router(mesh, part: RangePartition, *, bucket_cap: int,
                           axis: str = "data"):
    """On-mesh write dispatch: the bucketed all-to-all router over the
    ``data`` axis (one shard a rank), marker channel included.  Thin
    wrapper over ``core.distributed.make_route_edge_batches``; every rank
    calls the returned ``route(src, dst, prop, marker, n_valid)`` with its
    own batch."""
    return make_route_edge_batches(
        mesh, v_local=part.v_local, n_shards=part.n_shards,
        bucket_cap=bucket_cap, axis=axis)


__all__ = ["bucket_edge_batches", "route_queries",
           "make_mesh_write_router"]
