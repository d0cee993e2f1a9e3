"""Vertex-range partitioning for the sharded graph service.

The port of ``repro.shard.partition`` (host-side numpy, as there).  One
``RangePartition`` describes how the vertex-id space splits over
``n_shards`` independent LSMGraph instances: shard ``s`` owns the contiguous
range ``[s * v_local, (s + 1) * v_local)`` — the same ``owner = src //
v_local`` rule the reference's mesh router computes on device, so a mesh
router of the port will agree with host-side bucketing by construction.

Queries outside ``[0, n_shards * v_local)`` live on **no shard**: they route
nowhere and resolve to empty adjacency (the same answer a single store gives
for a vertex it has never seen).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..core.types import StoreConfig


@dataclasses.dataclass(frozen=True)
class RangePartition:
    """Range partition of ``[0, vmax)`` over ``n_shards`` shards."""

    n_shards: int
    v_local: int   # vertices per shard (ceil(vmax / n_shards))
    vmax: int

    @classmethod
    def for_vmax(cls, vmax: int, n_shards: int) -> "RangePartition":
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if vmax < 1:
            raise ValueError(f"vmax must be >= 1, got {vmax}")
        v_local = -(-vmax // n_shards)  # ceil division
        return cls(n_shards=n_shards, v_local=v_local, vmax=vmax)

    def shard_range(self, shard: int) -> Tuple[int, int]:
        """[lo, hi) vertex range owned by ``shard`` (clipped to vmax)."""
        lo = shard * self.v_local
        return lo, min(lo + self.v_local, self.vmax)

    def owner_of(self, vids: np.ndarray) -> np.ndarray:
        """Owner shard per vertex id; -1 for ids living on no shard."""
        vids = np.asarray(vids, np.int64)
        owner = vids // self.v_local
        owner = np.where((vids >= 0) & (vids < self.vmax), owner, -1)
        return owner.astype(np.int64)

    def split_by_owner(self, vids: np.ndarray
                       ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Group a query vector by owner shard, preserving relative order.

        Returns ``(per_shard_vids, per_shard_pos)`` — parallel lists over
        shards; ``per_shard_pos[s]`` holds the caller-order positions of
        ``per_shard_vids[s]``, i.e. the permutation the reassembly step
        inverts (the host-side analog of the ``all_gather`` + inverse
        permutation on the mesh).  No-shard ids appear in neither list.
        """
        vids = np.asarray(vids, np.int64).ravel()
        owner = self.owner_of(vids)
        per_vids: List[np.ndarray] = []
        per_pos: List[np.ndarray] = []
        for s in range(self.n_shards):
            pos = np.nonzero(owner == s)[0]
            per_pos.append(pos)
            per_vids.append(vids[pos])
        return per_vids, per_pos


def shard_scaled_config(cfg: StoreConfig, n_shards: int) -> StoreConfig:
    """Per-shard ``StoreConfig``: capacity tiers scaled to the shard's 1/S
    slice of the graph.

    Every fixed-capacity MemGraph array (hash table, segment pool, overflow
    log) is a per-read/-write cost — ``scan_vertices_batch`` emits
    ``B*G + ovf_cap`` records no matter how full the store is — so a shard
    provisioned like the whole graph pays whole-graph fixed costs on 1/S of
    the data and the aggregate does S times the work of one store.  Scaling
    capacities with the partition keeps total provisioned capacity (and
    per-op fixed cost) constant across shard counts, so a scaling sweep
    measures routing + parallelism, not capacity inflation.  The vertex-id
    space (``vmax``) stays GLOBAL.

    Floors keep the scaled config valid (hash stays a power of two; the
    segment-pool + overflow capacity still covers ``mem_edges``; the batch
    cap never exceeds the flush threshold).
    """
    if n_shards <= 1:
        return cfg
    p2 = 1 << max(0, n_shards.bit_length() - 1)   # power of two <= n_shards
    mem_edges = max(cfg.mem_edges // n_shards, 256)
    batch_cap = min(cfg.batch_cap, mem_edges)
    hash_slots = max(cfg.hash_slots // p2, 512)
    n_segments = max(cfg.n_segments // n_shards, 2 * batch_cap)
    ovf_cap = max(cfg.ovf_cap // n_shards, 2 * batch_cap)
    while n_segments * cfg.seg_size + ovf_cap < mem_edges:
        n_segments *= 2
    return dataclasses.replace(
        cfg, mem_edges=mem_edges, batch_cap=batch_cap,
        hash_slots=hash_slots, n_segments=n_segments, ovf_cap=ovf_cap,
        seg_target_edges=max(cfg.seg_target_edges // n_shards, 1024))


__all__ = ["RangePartition", "shard_scaled_config"]
