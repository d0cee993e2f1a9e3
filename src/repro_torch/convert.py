"""State carried between the JAX package and the port, as numpy arrays.

The port's NamedTuples have the reference's fields, dtypes and padding, so
a conversion is field by field: ``*_to_torch`` takes anything whose fields
``np.asarray`` can read (jax arrays, numpy arrays) and returns the port's
tensors on ``device``; ``to_numpy`` goes back.  Presence words are uint32
in the reference and int32 bit patterns in the port.  Nothing here imports
the JAX package: the caller hands over arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Type

import numpy as np
import torch

from .core.index import IndexState
from .core.types import CSRRunArrays, EdgeBatch, MemGraphState

_DTYPES = {np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


def array_to_torch(x, device) -> torch.Tensor:
    """One array (int32, float32 or bool, any shape) as a tensor."""
    a = np.array(x, copy=True)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def _tuple_to_torch(obj, cls: Type[NamedTuple], device):
    return cls(*(array_to_torch(getattr(obj, f), device)
                 for f in cls._fields))


def to_numpy(obj):
    """A port NamedTuple (or one tensor) as numpy arrays, field by field."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return type(obj)(*(to_numpy(getattr(obj, f)) for f in obj._fields))


def csr_run_to_torch(run, device) -> CSRRunArrays:
    return _tuple_to_torch(run, CSRRunArrays, device)


def memgraph_to_torch(mg, device) -> MemGraphState:
    return _tuple_to_torch(mg, MemGraphState, device)


def index_to_torch(idx, device) -> IndexState:
    return _tuple_to_torch(idx, IndexState, device)


def edge_batch_to_torch(batch, device) -> EdgeBatch:
    return _tuple_to_torch(batch, EdgeBatch, device)


def presence_words_to_torch(words, device) -> torch.Tensor:
    """uint32 filter words -> the port's int32 bit patterns."""
    return torch.from_numpy(
        np.asarray(words, np.uint32).view(np.int32).copy()).to(device)


def presence_words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 filter words -> the reference's uint32 words."""
    return words.cpu().numpy().view(np.uint32)
