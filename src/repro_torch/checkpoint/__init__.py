"""Fault-tolerant sharded checkpointing (the port of ``repro.checkpoint``)."""
from .manager import CheckpointManager
from .elastic import reshard_state

__all__ = ["CheckpointManager", "reshard_state"]
