"""Elastic resharding: restore a checkpoint onto another device or mesh
(the port of ``repro.checkpoint.elastic``).

Checkpoints are stored unsharded-logical (full arrays per leaf), so
placing one needs no data transformation.  The reference places each leaf
with ``jax.device_put(leaf, NamedSharding(mesh, spec))``; the port on one
card has no ``NamedSharding``: a state goes whole to one device, or, for a
``repro_torch.launch.mesh.ShardMesh``, whole to the device of the calling
rank (every rank calls it: the state is replicated).  Batch-schedule
continuity is the data pipeline's job (its state rides in the checkpoint
manifest).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _place(x, dev: torch.device):
    if isinstance(x, nn.Module):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _place(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_place(v, dev) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_place(v, dev) for v in x)
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def reshard_state(state, device_or_mesh):
    """Place a (host) state tree (dicts, lists, tuples, NamedTuples over
    NumPy arrays or tensors, or modules) on a device, or replicated on the
    calling rank's device of a ``ShardMesh``."""
    dev = getattr(device_or_mesh, "device", device_or_mesh)
    return _place(state, torch.device(dev))
