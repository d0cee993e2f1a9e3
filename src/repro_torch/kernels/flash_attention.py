"""Blocked (flash) attention with GQA and an optional causal mask: the port
of ``repro.kernels.flash_attention``.

Shapes keep the reference's layout: ``q`` [B, Hq, Sq, D], ``k`` and ``v``
[B, Hkv, Skv, D], ``Hq % Hkv == 0``; query head h reads kv head
``h // (Hq // Hkv)``.  With ``causal`` query row i sees key j only if
``j <= i + Skv - Sq``.  The output has ``q.dtype``.

``flash_attention_cuda`` launches one of the two hand-written kernels of
``csrc/flash_attention.cu`` (float32, bfloat16 or float16; D in
``HEAD_DIMS``; both sequence lengths multiples of 128, as the reference
asserts).  Which one depends only on the dtype and D (``kernel_path``):
bfloat16 and float16 at D 64 and 128 take the tensor-core kernel, the rest
the CUDA-core one.  ``mha_ref`` is the plain version of both, the port of
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
#: dtypes and head dims of the tensor-core kernel (``flash_mma_kernel``).
MMA_DTYPES = (torch.bfloat16, torch.float16)
MMA_HEAD_DIMS = (64, 128)
PATHS = ("tensor_cores", "cuda_cores")
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


def kernel_path(dtype: torch.dtype, d: int) -> str:
    """The kernel ``flash_attention_cuda`` launches for inputs of ``dtype``
    and head dim ``d``: ``"tensor_cores"`` or ``"cuda_cores"``."""
    if dtype in MMA_DTYPES and d in MMA_HEAD_DIMS:
        return "tensor_cores"
    return "cuda_cores"


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_PROTOTYPES = {"flash_attention_launch": _ARGTYPES,
               "flash_attention_mma_launch": _ARGTYPES}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, scale=None) -> torch.Tensor:
    """Launch a kernel of ``csrc/flash_attention.cu`` on the current stream:
    the tensor-core kernel or the CUDA-core one, as ``kernel_path`` says."""
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
    path = kernel_path(q.dtype, d)
    if path == "tensor_cores" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("the tensor-core kernel copies 16 bytes at a time: "
                         "q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    fn = _build.bind("flash_attention", _PROTOTYPES)[
        "flash_attention_mma_launch" if path == "tensor_cores"
        else "flash_attention_launch"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], b, hq, hkv, sq, skv, d, _scale(d, scale),
                int(bool(causal)), stream)
    _build.check(rc, f"flash_attention ({path})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.path_launches[path] += 1
    return out


flash_attention_cuda.launches = 0
#: Launches of each kernel since import, for logs; ``launches`` counts both
#: and is the count ``ops.reset_launches`` zeroes.
flash_attention_cuda.path_launches = dict.fromkeys(PATHS, 0)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale=None) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors.  Both
    hold the reference's preconditions."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    check_shapes(q, k, v)
    return mha_ref(q, k, v, causal=causal, scale=scale)
