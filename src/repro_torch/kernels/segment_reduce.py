"""Fused gather + segment reduction over sorted CSR edges: the analytics
inner loop (port of ``repro.kernels.segment_reduce``).

    gather_segsum: y[s] = sum over e with seg_id[e] == s of wt[e] * x[dst[e]]
    gather_segmin: y[s] = min over those e of (wt[e] + x[dst[e]])

``seg_id`` does not decrease (CSR order).  As in the reference's plain
versions (``repro.kernels.ref``), ``dst`` is clipped to ``[0, len(x) - 1]``,
``seg_id`` to ``[0, n_out - 1]``, and an edge with ``seg_id >= n_out`` is
dropped: it adds 0 to a sum and 3.0e38 to a min.  A segment with no edge
gets 0 or 3.0e38 (the float32 value of the reference's ``_INF``).

``gather_segsum_runs`` is the segment sum over many runs laid end to end
(the merge-free multi-level PageRank): ``seg_id`` is sorted within each run
only, and a source id may recur in any run; the result is the sum of one
``gather_segsum`` a run.

``gather_seg*_cuda`` launch the hand-written kernels of
``csrc/segment_reduce.cu``; ``gather_seg*_ref`` are the plain versions
(``index_add_`` and ``scatter_reduce_(..., "amin")``); ``gather_seg*`` pick
by the device of the tensors they are given.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

INF = 3.0e38   # float32 value of "no edge" for segmin


def _clipped(dst, seg_id, x, n_out):
    d = dst.clamp(0, x.shape[0] - 1).long()
    return d, seg_id.clamp(0, n_out - 1).long(), seg_id < n_out


def gather_segsum_ref(dst: torch.Tensor, seg_id: torch.Tensor,
                      wt: torch.Tensor, x: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """Plain version of the segment-sum kernel: float32[n_out]."""
    y = torch.zeros((n_out,), dtype=torch.float32, device=x.device)
    if n_out == 0 or dst.shape[0] == 0:
        return y
    d, s, keep = _clipped(dst, seg_id, x, n_out)
    vals = wt.float() * x.float()[d]
    return y.index_add_(0, s, torch.where(keep, vals, 0.0))


def gather_segmin_ref(dst: torch.Tensor, seg_id: torch.Tensor,
                      wt: torch.Tensor, x: torch.Tensor,
                      n_out: int) -> torch.Tensor:
    """Plain version of the segment-min kernel: float32[n_out]."""
    y = torch.full((n_out,), INF, dtype=torch.float32, device=x.device)
    if n_out == 0 or dst.shape[0] == 0:
        return y
    d, s, keep = _clipped(dst, seg_id, x, n_out)
    vals = wt.float() + x.float()[d]
    return y.scatter_reduce_(0, s, torch.where(keep, vals, INF), "amin")


def gather_segsum_runs_ref(dst: torch.Tensor, seg_id: torch.Tensor,
                           wt: torch.Tensor, x: torch.Tensor,
                           n_out: int) -> torch.Tensor:
    """Plain version of the multi-run segment sum: one ``index_add_`` over
    every run's records laid end to end (an add does not need sorted ids)."""
    return gather_segsum_ref(dst, seg_id, wt, x, n_out)


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
_PROTOTYPES = {f"{name}_launch": _ARGTYPES for name in (
    "gather_segsum", "gather_segmin", "gather_segsum_runs")}


def _launch(entry: str, dst, seg_id, wt, x, n_out: int) -> torch.Tensor:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} needs CUDA tensors")
    _build.check_vector(dst, "dst", torch.int32, dev)
    _build.check_vector(seg_id, "seg_id", torch.int32, dev)
    _build.check_vector(wt, "wt", torch.float32, dev)
    _build.check_vector(x, "x", torch.float32, dev)
    e, n_out = dst.shape[0], int(n_out)
    if seg_id.shape[0] != e or wt.shape[0] != e:
        raise ValueError("dst, seg_id and wt must have one entry per edge")
    if e and x.shape[0] == 0:
        raise ValueError("x is empty but there are edges to gather")
    if not 0 <= n_out < 1 << 31 or x.shape[0] >= 1 << 31:
        raise ValueError("n_out and len(x) must fit in int32")
    y = torch.empty((n_out,), dtype=torch.float32, device=dev)
    fn = _build.bind("segment_reduce", _PROTOTYPES)[f"{entry}_launch"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(dst.data_ptr(), seg_id.data_ptr(), wt.data_ptr(),
                x.data_ptr(), y.data_ptr(), e, x.shape[0], n_out, stream)
    _build.check(rc, entry)
    return y


def gather_segsum_cuda(dst, seg_id, wt, x, n_out: int) -> torch.Tensor:
    """Launch the segment-sum kernel of ``csrc/segment_reduce.cu`` on the
    current stream: float32[n_out]."""
    y = _launch("gather_segsum", dst, seg_id, wt, x, n_out)
    gather_segsum_cuda.launches += 1
    return y


def gather_segmin_cuda(dst, seg_id, wt, x, n_out: int) -> torch.Tensor:
    """Launch the segment-min kernel of ``csrc/segment_reduce.cu`` on the
    current stream: float32[n_out]."""
    y = _launch("gather_segmin", dst, seg_id, wt, x, n_out)
    gather_segmin_cuda.launches += 1
    return y


def gather_segsum_runs_cuda(dst, seg_id, wt, x, n_out: int) -> torch.Tensor:
    """Launch the multi-run segment-sum kernel of ``csrc/segment_reduce.cu``
    on the current stream, once over every run's records laid end to end:
    float32[n_out]."""
    y = _launch("gather_segsum_runs", dst, seg_id, wt, x, n_out)
    gather_segsum_runs_cuda.launches += 1
    return y


gather_segsum_cuda.launches = 0
gather_segmin_cuda.launches = 0
gather_segsum_runs_cuda.launches = 0


def gather_segsum(dst, seg_id, wt, x, *, n_out: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return gather_segsum_cuda(dst, seg_id, wt, x, n_out)
    return gather_segsum_ref(dst, seg_id, wt, x, n_out)


def gather_segmin(dst, seg_id, wt, x, *, n_out: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return gather_segmin_cuda(dst, seg_id, wt, x, n_out)
    return gather_segmin_ref(dst, seg_id, wt, x, n_out)


def gather_segsum_runs(dst, seg_id, wt, x, *, n_out: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.is_cuda:
        return gather_segsum_runs_cuda(dst, seg_id, wt, x, n_out)
    return gather_segsum_runs_ref(dst, seg_id, wt, x, n_out)
