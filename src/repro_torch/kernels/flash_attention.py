"""Blocked (flash) attention with GQA and an optional causal mask: the port
of ``repro.kernels.flash_attention``.

Shapes keep the reference's layout: ``q`` [B, Hq, Sq, D], ``k`` and ``v``
[B, Hkv, Skv, D], ``Hq % Hkv == 0``; query head h reads kv head
``h // (Hq // Hkv)``.  With ``causal`` query row i sees key j only if
``j <= i + Skv - Sq``.  The output has ``q.dtype``.

``flash_attention_cuda`` launches the hand-written kernel
``csrc/flash_attention.cu`` (float32, bfloat16 or float16; D in
``HEAD_DIMS``; both sequence lengths multiples of 128, as the reference
asserts).  ``mha_ref`` is its plain version, the port of
``repro.kernels.ref.mha_ref``, for any D.  ``flash_attention`` picks by the
device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

BLOCK = 128                     # the reference's tile: Sq, Skv multiples
HEAD_DIMS = (32, 64, 128, 256)  # the kernel's template instantiations
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_NEG = -1e30


def _scale(d: int, scale) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, scale=None) -> torch.Tensor:
    """Plain version: GQA by repeating kv heads, the causal mask filled with
    -1e30, softmax in float32, then p cast to q's type for the second
    product.  The default scale is the reference's ``1 / np.sqrt(d)``, a
    float64 NumPy scalar that promotes the logits to float32; a scale
    given as a Python float keeps them in q's type, as in JAX."""
    _b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k)
    if scale is None:
        logits = logits.float()
    logits = logits * _scale(d, scale)
    if causal:
        skv = k.shape[2]
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        logits = torch.where(mask, logits, _NEG)
    p = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def check_shapes(q, k, v) -> None:
    """The reference's preconditions (``flash_attention.py:68``)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D]")
    b, hq, sq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if hq % k.shape[1] or sq % BLOCK or k.shape[2] % BLOCK:
        raise ValueError(f"need Hq % Hkv == 0 and sequence lengths that are "
                         f"multiples of {BLOCK}: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale=None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on the current stream."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention_cuda needs CUDA tensors")
    check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor of q's "
                             f"dtype on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_cuda takes float32, bfloat16 or "
                        f"float16, not {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda has head dims {HEAD_DIMS}, "
                         f"not {d}; the plain version mha_ref takes any")
    if max(b, hq, sq, skv) >= 1 << 31 or b > 65535 or hq > 65535:
        raise ValueError("shape too large for the kernel's grid")
    out = torch.empty_like(q)
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, hq, hkv, sq, skv, d, _scale(d, scale),
                int(bool(causal)), stream)
    _build.check(rc, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, *, causal: bool = True,
                    scale=None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.  Both
    hold the reference's preconditions."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    check_shapes(q, k, v)
    return mha_ref(q, k, v, causal=causal, scale=scale)
