"""Batched binary search over a run's sorted vertex keys: the probe of the
no-multi-level-index read (paper Fig 16's ablation baseline), the port of
``repro.kernels.lookup``.

``batched_searchsorted(keys, queries, n_keys)`` gives, for every int32
query, its left insertion point into ``keys[:n_keys]`` (sorted int32; the
slots past ``n_keys`` are read as ``INT32_MAX``), as int32.  ``n_keys`` may
be an int or a 0-d / 1-element tensor on the keys' device: a run's fill
count ``run.nv`` is handed over as it is, with no copy to the host.

``batched_searchsorted_cuda`` launches the hand-written kernel
``csrc/lookup.cu``; ``batched_searchsorted_ref`` is its plain version (the
port of ``repro.kernels.ref.searchsorted_ref``).  ``batched_searchsorted``
picks by the device of the tensors it is given.  The reference's Pallas
kernel returns ``n_keys + 1`` where ``keys[n_keys] < q`` (ROADMAP, faults of
the reference); the port computes the plain version's definition.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

I32MAX = (1 << 31) - 1


def _n_keys_tensor(n_keys, device) -> torch.Tensor:
    """``n_keys`` as a 1-element int32 tensor on ``device`` (a view of a
    0-d int32 tensor already there; nothing waits for the card)."""
    if isinstance(n_keys, torch.Tensor):
        if n_keys.numel() != 1:
            raise ValueError("n_keys must hold one value")
        return n_keys.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(n_keys)], dtype=torch.int32, device=device)


def batched_searchsorted_ref(keys: torch.Tensor, queries: torch.Tensor,
                             n_keys) -> torch.Tensor:
    """Plain version: mask ``keys[n_keys:]`` to INT32_MAX and take the left
    insertion points of ``queries`` (int32[nq])."""
    n = _n_keys_tensor(n_keys, keys.device)
    valid = torch.arange(keys.shape[0], device=keys.device) < n
    k = torch.where(valid, keys, I32MAX).to(torch.int32)
    return torch.searchsorted(k, queries.to(torch.int32)).to(torch.int32)


def batched_searchsorted_cuda(keys: torch.Tensor, queries: torch.Tensor,
                              n_keys) -> torch.Tensor:
    """Launch ``csrc/lookup.cu`` on the current stream: int32[nq]."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError("batched_searchsorted_cuda needs CUDA tensors")
    _build.check_vector(keys, "keys", torch.int32, dev)
    _build.check_vector(queries, "queries", torch.int32, dev)
    n = _n_keys_tensor(n_keys, dev)
    if keys.shape[0] >= 1 << 31 or queries.shape[0] >= 1 << 31:
        raise ValueError("keys and queries must have fewer than 2**31 items")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    fn = _build.load("lookup").batched_searchsorted_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(keys.data_ptr(), queries.data_ptr(), n.data_ptr(),
                out.data_ptr(), queries.shape[0], keys.shape[0], stream)
    _build.check(rc, "batched_searchsorted")
    batched_searchsorted_cuda.launches += 1
    return out


batched_searchsorted_cuda.launches = 0


def batched_searchsorted(keys, queries, n_keys) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if queries.is_cuda:
        return batched_searchsorted_cuda(keys, queries, n_keys)
    return batched_searchsorted_ref(keys, queries, n_keys)
