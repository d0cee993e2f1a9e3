"""Write and read routing for the sharded graph service.

The port of ``repro.shard.router``'s host tiers.  Both share the ownership
rule (``RangePartition``):

* **Write router** — ``bucket_edge_batches`` groups one ``(src, dst,
  prop)`` update batch by owner shard on the host.  Deletes route by the
  same rule, so a tombstone reaches the shard of the insert it annihilates.

* **Read router** — ``route_queries`` splits a query vector by owner and
  remembers each query's caller-order position (``per_pos`` is the inverse
  permutation).  ``ShardedSnapshot`` assembles results without a scatter:
  ``query_edges_batch`` writes each shard's answers straight into the
  output at ``per_pos[s]``, and ``neighbors_batch`` routes the SORTED
  unique query vector as contiguous per-shard slices, so the gathered
  (offsets, dst, prop) triples concatenate back in order.

The reference's third tier, ``make_mesh_write_router`` (the bucketed
``all_to_all`` over a device mesh), wraps ``core/distributed.py`` and is
not in the port yet: it waits for the port of ``core/distributed.py`` to
``torch.distributed``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

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


__all__ = ["bucket_edge_batches", "route_queries"]
