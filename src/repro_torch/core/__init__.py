"""LSMGraph core — the PyTorch port of ``repro.core``.

Entry point: ``LSMGraph(cfg, device=None)``.  ``device=None`` puts every
tensor of the store on the current CUDA card and raises when there is none;
``device="cpu"`` runs the same code, with each kernel's plain version, on
the CPU.  The concurrency model is the reference's: one immutable,
atomically published ``StoreState``; snapshots take no writer lock; the
shared read spine is owned by the state and built at most once per sealed
epoch.
"""
from .types import (BYTES_PER_EDGE, BYTES_PER_PROP, INVALID_VID, CSRRunArrays,
                    EdgeBatch, IOCounters, MemGraphState, RunFile, StoreConfig,
                    Version)
from .store import LSMGraph, Snapshot, StoreState
from .versions import VersionChain
from . import csr, filters, index, memgraph

__all__ = [
    "BYTES_PER_EDGE", "BYTES_PER_PROP", "INVALID_VID", "CSRRunArrays",
    "EdgeBatch", "IOCounters", "MemGraphState", "RunFile", "StoreConfig",
    "Version", "LSMGraph", "Snapshot", "StoreState", "VersionChain", "csr",
    "filters", "index", "memgraph",
]
