"""Sharded graph service: vertex-range LSMGraph shards on one device.

The port of ``repro.shard``.  The single-node store
(``repro_torch.core.store``) serves a point-read batch in a few device
passes over its visible runs; this package composes ``n_shards`` of those
stores into the service's scale-out tier.  Every shard of one
``ShardedGraphStore`` lives on the same device (``device=None``: the current
CUDA card; raises when there is none), and its own directory when durable.

Partition / route / reassemble flow
-----------------------------------

::

                     writes (src, dst, prop)
                        |  owner = src // v_local
           +------------+-------------+
           v            v             v          bucket_edge_batches
       shard 0       shard 1  ...  shard S-1
      (LSMGraph)    (LSMGraph)    (LSMGraph)
       WAL 0          WAL 1         WAL S-1      <- per-shard commit seqs
           ^            ^             ^
           |  queries vs routed by owner; per-shard
           |  batched resolve of its range (pool threads)
           +------------+-------------+
                        |  gather + inverse permutation
                 results in caller order

* **Partition** (``partition.RangePartition``): vertex ranges, shard ``s``
  owns ``[s * v_local, (s + 1) * v_local)`` (``owner = src // v_local``).
* **Route** (``router``): writes bucket by owner and apply shard-locally
  (each shard runs its own MemGraph -> L0 -> L1 pipeline and its own WAL);
  reads split the query vector by owner, keeping every occurrence's
  caller-order position.
* **Reassemble**: per-shard batched results concatenate and scatter back
  through the inverse permutation; vertices owned by no shard resolve to
  empty adjacency — element-wise identical to one store holding the whole
  graph.

The reference's on-mesh write router (``make_mesh_write_router``, a
bucketed ``all_to_all`` over ``core/distributed.py``) is not ported yet: it
waits for the port of ``core/distributed.py`` to ``torch.distributed``.

Tau-epoch snapshot protocol
---------------------------

Shards advance independent timestamp counters, so "a consistent cut" needs
coordination.  ``ShardedGraphStore`` keeps a coordinator **epoch**: every
routed write applies to ALL its owner shards while holding the epoch lock,
and ``snapshot()`` pins every shard's ``Snapshot`` (collecting the vector of
per-shard taus) under that same lock.  A multi-shard read therefore never
mixes pre-/post-batch states across shards — a SUCCESSFUL batch is visible
on every owner shard or on none.  (A batch whose apply RAISES on some shard
is drained before the error propagates but stays partially applied; there
is no cross-shard rollback.)

Durability acks
---------------

Each shard owns a WAL whose appends return monotonically increasing commit
seqs.  A routed write returns a ``ShardWriteReceipt`` with one seq per
touched shard; ``ack(receipt)`` awaits ``sync_upto(seq)`` on exactly those
shards' logs — callers pay for the fsync of *their* batch on *their* shards
only.

Compaction scheduling policy
----------------------------

``scheduler.CompactionScheduler`` compacts one worst-offender shard per
tick while the rest keep ingesting: ``score(s) = l0_weight * L0_depth(s) +
read_weight * runs_per_query(s)`` over shards with at least ``min_l0`` L0
runs that are neither fenced nor HOT (their ``shard_ack_seconds`` count
advanced since the last tick), with a backoff on the windowed mean ack
latency.  Decisions land in the ``compaction_sched_*`` metric families.
"""
from __future__ import annotations

from .partition import RangePartition, shard_scaled_config
from .router import bucket_edge_batches, route_queries
from .scheduler import CompactionScheduler
from .store import (DegradedReport, ShardUnavailable, ShardWriteReceipt,
                    ShardedGraphStore, ShardedSnapshot, open_sharded_store)

__all__ = [
    "CompactionScheduler", "DegradedReport", "RangePartition",
    "ShardUnavailable", "ShardWriteReceipt", "ShardedGraphStore",
    "ShardedSnapshot", "bucket_edge_batches", "open_sharded_store",
    "route_queries", "shard_scaled_config",
]
