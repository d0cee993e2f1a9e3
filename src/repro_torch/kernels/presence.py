"""Vertex-presence test of a query vector against every run's filter.

One call answers "which of these B query vertices might each of these R
runs contain?" as a bool[R, B] hit matrix — the batched read path's
pre-gate (the port of ``repro.kernels.presence``).  The filters are ragged:
``words`` holds every run's packed bits back to back as int32 bit patterns,
``offs[r]`` (int64) is the first word of run r and ``masks[r]`` (int32) its
``mbits - 1``.  The hash is the splitmix32 double hash of ``core.filters``,
formula-identical by contract, so a key inserted at build time can never
miss at query time.

``presence_matrix_cuda`` launches the hand-written kernel
``csrc/presence.cu``, which stages a filter of at most ``stage_words()``
words in shared memory and probes a larger one through L2;
``presence_matrix_ref`` is its plain PyTorch version,
which computes the uint32 arithmetic in int64 masked to 32 bits (torch has
no ``>>`` on uint32 on the CPU).  ``presence_matrix`` picks by the device of
the tensors it is given.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.filters import FILTER_K, FILTER_SALT
from . import _build

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32): the constant is split in
    16-bit halves so that no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """uint32 avalanche over int64 — MUST mirror ``core.filters._mix32``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def presence_matrix_ref(words: torch.Tensor, offs: torch.Tensor,
                        masks: torch.Tensor,
                        queries: torch.Tensor) -> torch.Tensor:
    """Plain version: bool[R, B] from ragged int32 words, int64 offs[R],
    int32 masks[R] and int32 queries[B]."""
    q = queries.to(torch.int64) & _M32
    h1 = _mix32(q)
    h2 = _mix32(q ^ FILTER_SALT) | 1
    mask = (masks.to(torch.int64) & _M32)[:, None]
    base = offs.to(torch.int64)[:, None]
    w64 = words.to(torch.int64) & _M32
    hit = torch.ones((offs.shape[0], q.shape[0]), dtype=torch.bool,
                     device=q.device)
    for i in range(FILTER_K):
        pos = (h1 + i * h2)[None, :] & mask
        bits = w64[base + (pos >> 5)]
        hit &= ((bits >> (pos & 31)) & 1) != 0
    return hit


_PROTOTYPES = {"presence_matrix_launch": [ctypes.c_void_p] * 5 + [
    ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p],
    "presence_stage_words": []}


def stage_words() -> int:
    """Words of the largest filter the kernel stages in shared memory, as
    the built ``csrc/presence.cu`` states it."""
    return _build.bind("presence", _PROTOTYPES)["presence_stage_words"]()


def presence_matrix_cuda(words: torch.Tensor, offs: torch.Tensor,
                         masks: torch.Tensor,
                         queries: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/presence.cu`` on the current stream: bool[R, B]."""
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError("presence_matrix_cuda needs CUDA tensors")
    _build.check_vector(words, "words", torch.int32, dev)
    _build.check_vector(offs, "offs", torch.int64, dev)
    _build.check_vector(masks, "masks", torch.int32, dev)
    _build.check_vector(queries, "queries", torch.int32, dev)
    if offs.shape != masks.shape:
        raise ValueError("offs and masks must have one entry per run")
    r, b = offs.shape[0], queries.shape[0]
    out = torch.empty((r, b), dtype=torch.bool, device=dev)
    fn = _build.bind("presence", _PROTOTYPES)["presence_matrix_launch"]
    rc = _build.run_on(dev, fn, words.data_ptr(), offs.data_ptr(),
                       masks.data_ptr(), queries.data_ptr(), out.data_ptr(),
                       r, b, FILTER_K, FILTER_SALT)
    _build.check(rc, "presence_matrix")
    _build.count_launch(presence_matrix_cuda)
    return out


presence_matrix_cuda.launches = 0


def presence_matrix(words, offs, masks, queries) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if queries.is_cuda:
        return presence_matrix_cuda(words, offs, masks, queries)
    return presence_matrix_ref(words, offs, masks, queries)
