"""Batched binary search over a run's sorted vertex keys: the probe of the
no-multi-level-index read (paper Fig 16's ablation baseline), the port of
``repro.kernels.lookup``.

``batched_searchsorted(keys, queries, n_keys)`` gives, for every int32
query, its left insertion point into ``keys[:n_keys]`` (sorted int32; the
slots past ``n_keys`` are read as ``INT32_MAX``), as int32.  ``n_keys`` may
be an int or a 0-d / 1-element tensor on the keys' device: a run's fill
count ``run.nv`` is handed over as it is, with no copy to the host, and an
int goes to the kernel as an argument, with no copy to the card.

``batched_searchsorted_runs(keys, offs, n_keys, queries)`` is the same
search into every run of a store at once: run r's keys start at
``keys[offs[r]]`` (int64 offsets, nondecreasing) and end where run r + 1
starts (the last at the end of ``keys``); ``n_keys[r]`` (int32) is its fill
count.  It returns int32[R, B], row r equal to
``batched_searchsorted(run r's keys, queries, n_keys[r])``, in one launch
on the card.

``*_cuda`` launch the hand-written kernels of ``csrc/lookup.cu``; ``*_ref``
are their plain versions (the port of ``repro.kernels.ref.searchsorted_ref``,
and one ``torch.searchsorted`` over keys made unique across runs).  The
undecorated names pick by the device of the tensors they are given.  The
reference's Pallas kernel returns ``n_keys + 1`` where
``keys[n_keys] < q`` (ROADMAP, faults of the reference); the port computes
the plain version's definition.
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


def batched_searchsorted_runs_ref(keys: torch.Tensor, offs: torch.Tensor,
                                  n_keys: torch.Tensor,
                                  queries: torch.Tensor) -> torch.Tensor:
    """Plain version: int32[R, B].  Every slot of ``keys`` becomes the int64
    key (run << 32) | (key + 2**31), with the slots past a run's fill count
    read as INT32_MAX, so the keys of all runs form one sorted vector; one
    ``torch.searchsorted`` of every (run, query) pair made the same way,
    less the run's first slot, is the insertion point within the run."""
    dev = keys.device
    offs = offs.to(torch.int64)
    r, b = offs.shape[0], queries.shape[0]
    slot = torch.arange(keys.shape[0], device=dev)
    run = torch.searchsorted(offs, slot, right=True) - 1
    own = run.clamp(min=0)
    valid = (run >= 0) & (slot - offs[own] < n_keys.to(torch.int64)[own])
    k = torch.where(valid, keys.to(torch.int64), I32MAX) + (1 << 31)
    q = queries.to(torch.int64) + (1 << 31)
    at = torch.searchsorted(
        (run << 32) | k,
        ((torch.arange(r, device=dev) << 32)[:, None] | q).reshape(-1))
    return (at.reshape(r, b) - offs[:, None]).to(torch.int32)


_PROTOTYPES = {
    "batched_searchsorted_launch": [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p],
    "batched_searchsorted_runs_launch": [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p]}


def batched_searchsorted_cuda(keys: torch.Tensor, queries: torch.Tensor,
                              n_keys) -> torch.Tensor:
    """Launch ``csrc/lookup.cu`` on the current stream: int32[nq].  An int
    ``n_keys`` is clamped to [0, len(keys)] here and passed as the length
    with no count on the card; a tensor is read by the kernel."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError("batched_searchsorted_cuda needs CUDA tensors")
    _build.check_vector(keys, "keys", torch.int32, dev)
    _build.check_vector(queries, "queries", torch.int32, dev)
    if keys.shape[0] >= 1 << 31 or queries.shape[0] >= 1 << 31:
        raise ValueError("keys and queries must have fewer than 2**31 items")
    cap = keys.shape[0]
    if isinstance(n_keys, torch.Tensor):
        n = _n_keys_tensor(n_keys, dev)
        n_ptr = n.data_ptr()
    else:
        n_ptr, cap = None, min(max(int(n_keys), 0), cap)
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    fn = _build.bind("lookup", _PROTOTYPES)["batched_searchsorted_launch"]
    rc = _build.run_on(dev, fn, keys.data_ptr(), queries.data_ptr(), n_ptr,
                       out.data_ptr(), queries.shape[0], cap)
    _build.check(rc, "batched_searchsorted")
    _build.count_launch(batched_searchsorted_cuda)
    return out


batched_searchsorted_cuda.launches = 0


def batched_searchsorted_runs_cuda(keys: torch.Tensor, offs: torch.Tensor,
                                   n_keys: torch.Tensor,
                                   queries: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/lookup.cu``'s multi-run form on the current stream:
    int32[R, B], one launch for every run."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError("batched_searchsorted_runs_cuda needs CUDA tensors")
    _build.check_vector(keys, "keys", torch.int32, dev)
    _build.check_vector(offs, "offs", torch.int64, dev)
    _build.check_vector(n_keys, "n_keys", torch.int32, dev)
    _build.check_vector(queries, "queries", torch.int32, dev)
    if offs.shape != n_keys.shape:
        raise ValueError("offs and n_keys must have one entry per run")
    if queries.shape[0] >= 1 << 31 or offs.shape[0] >= 1 << 31:
        raise ValueError("runs and queries must number fewer than 2**31")
    r, b = offs.shape[0], queries.shape[0]
    out = torch.empty((r, b), dtype=torch.int32, device=dev)
    fn = _build.bind("lookup", _PROTOTYPES)[
        "batched_searchsorted_runs_launch"]
    rc = _build.run_on(dev, fn, keys.data_ptr(), offs.data_ptr(),
                       n_keys.data_ptr(), queries.data_ptr(), out.data_ptr(),
                       r, b, keys.shape[0])
    _build.check(rc, "batched_searchsorted_runs")
    _build.count_launch(batched_searchsorted_runs_cuda)
    return out


batched_searchsorted_runs_cuda.launches = 0


def batched_searchsorted(keys, queries, n_keys) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if queries.is_cuda:
        return batched_searchsorted_cuda(keys, queries, n_keys)
    return batched_searchsorted_ref(keys, queries, n_keys)


def batched_searchsorted_runs(keys, offs, n_keys, queries) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if queries.is_cuda:
        return batched_searchsorted_runs_cuda(keys, offs, n_keys, queries)
    return batched_searchsorted_runs_ref(keys, offs, n_keys, queries)
