"""Gradient compression for the data-parallel all-reduce (the port of
``repro.optim.grad_compress``).

int8 block quantization with error feedback: each step's quantization
residual is carried into the next step, so the compressed optimizer
matches the exact one in expectation (EF-SGD).  The wire carries int8
values and one float32 scale per 256 elements.  The reference's mean runs
inside ``shard_map`` over a mesh axis; the port's runs over the ranks of a
``repro_torch.launch.mesh.ShardMesh``.

The divisions are by float32 tensors: on a CUDA tensor a division by a
Python scalar is a product by its reciprocal, which rounds differently,
and the int8 values must be the CPU's (and the reference's) bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

_BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    n = x.numel()
    return F.pad(x.reshape(-1), (0, (-n) % _BLOCK)), n


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                       -127, 127).to(torch.int8)


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values [blocks, 256], float32 per-block scales)."""
    flat, _ = _pad_to_block(g.to(torch.float32))
    blocks = flat.reshape(-1, _BLOCK)
    scale = _div(blocks.abs().amax(1, keepdim=True), 127.0)
    return _quantize(blocks, scale), scale[:, 0]


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype=torch.float32) -> torch.Tensor:
    blocks = q.to(torch.float32) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(shape).to(dtype)


def compressed_psum_cb(grads: Dict[str, torch.Tensor],
                       residuals: Dict[str, torch.Tensor], mesh,
                       axis: str = "data"):
    """Compressed data-parallel mean with error feedback over the ranks of
    ``mesh`` (a ``ShardMesh``; every rank calls it with its own gradients
    and residuals, dicts by name).  A shared per-block scale (the max over
    the ranks) makes the int8 payload directly summable; the sum is in
    int32.  -> (the means in each gradient's dtype, the new float32
    residuals)."""
    n_dev = mesh.shape[mesh.axis_names.index(axis)]
    mean, res = {}, {}
    for k, g in grads.items():
        g_ef = g.to(torch.float32) + residuals[k]
        flat, n = _pad_to_block(g_ef)
        blocks = flat.reshape(-1, _BLOCK)
        local_amax = blocks.abs().amax(1)
        scale = _div(mesh.all_reduce(local_amax, dist.ReduceOp.MAX, axis),
                     127.0)[:, None]
        q = _quantize(blocks, scale)
        deq_local = (q.to(torch.float32) * scale).reshape(-1)[:n].reshape(
            g.shape)
        res[k] = g_ef - deq_local
        q_sum = mesh.all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, axis)
        mean[k] = _div(q_sum.to(torch.float32) * scale, float(n_dev)
                       ).reshape(-1)[:n].reshape(g.shape).to(g.dtype)
    return mean, res


def compression_ratio(shape, dtype_bytes: int = 4) -> float:
    n = 1
    for s in shape:
        n *= s
    comp = n + 4 * ((n + _BLOCK - 1) // _BLOCK)
    return (n * dtype_bytes) / comp
