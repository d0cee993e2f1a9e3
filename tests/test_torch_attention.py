"""The port's attention operator (its plain version on the CPU) against the
JAX package's blocked-attention kernel, run in interpret mode as the JAX
package's own tests run it.

Inputs are made with numpy from fixed seeds and go through both packages.
Tolerance: rtol 1e-3 / atol 2e-3 in float32, the tolerance of
``tests/test_kernels.py`` (the kernel's streaming softmax adds in another
order than the plain softmax); atol 2e-2 in bfloat16, whose 8 significant
bits round p and the output at other places in each implementation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F32_TOL = dict(rtol=1e-3, atol=2e-3)


def _case(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _port(q, k, v, causal, dtype=torch.float32):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    out = ops.attention(*t, causal=causal)
    assert out.dtype == dtype and out.shape == t[0].shape
    via_kernel_entry = ops.attention(*t, causal=causal, use_pallas=True)
    assert torch.equal(out, via_kernel_entry)   # CPU: the plain version
    return out.float().numpy()


def _pallas(q, k, v, causal, dtype=jnp.float32):
    out = jops.attention(*(jnp.asarray(x, dtype) for x in (q, k, v)),
                         causal=causal, use_pallas=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,s,d", [
    (1, 4, 2, 256, 64), (2, 2, 2, 128, 128), (1, 8, 1, 128, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_jax(b, hq, hkv, s, d, causal):
    """``tests/test_kernels.py``'s shapes, causal and not."""
    q, k, v = _case(s + d + hq, b, hq, hkv, s, s, d)
    np.testing.assert_allclose(_port(q, k, v, causal),
                               _pallas(q, k, v, causal), **F32_TOL)


@pytest.mark.parametrize("sq,skv", [(128, 384), (256, 128), (384, 128)])
def test_attention_causal_offset_matches_jax(sq, skv):
    """The causal mask is offset by Skv - Sq.  With Sq > Skv the first
    Sq - Skv rows see no key and both packages give the mean of v."""
    q, k, v = _case(sq * 7 + skv, 1, 4, 2, sq, skv, 64)
    port = _port(q, k, v, True)
    np.testing.assert_allclose(port, _pallas(q, k, v, True), **F32_TOL)
    if sq > skv:
        blind = port[:, :, :sq - skv]
        mean_v = np.repeat(v.mean(axis=2, keepdims=True), 2, axis=1)
        np.testing.assert_allclose(
            blind, np.broadcast_to(mean_v, blind.shape), **F32_TOL)


def test_attention_bfloat16_matches_jax():
    q, k, v = _case(11, 1, 4, 4, 128, 128, 64)
    port = _port(q, k, v, True, torch.bfloat16)
    np.testing.assert_allclose(port, _pallas(q, k, v, True, jnp.bfloat16),
                               rtol=0.0, atol=2e-2)


def test_attention_explicit_scale_matches_jax():
    q, k, v = _case(12, 1, 2, 1, 128, 256, 32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    port = ops.attention(*t, scale=0.3).numpy()
    want = np.asarray(jops.attention(*(jnp.asarray(x) for x in (q, k, v)),
                                     scale=0.3, use_pallas=True))
    np.testing.assert_allclose(port, want, **F32_TOL)


def test_flash_attention_keeps_reference_preconditions():
    q, k, v = (torch.from_numpy(x) for x in _case(1, 1, 3, 2, 128, 128, 32))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        flash.flash_attention(q, k, v)
    q, k, v = (torch.from_numpy(x) for x in _case(2, 1, 2, 2, 96, 128, 32))
    with pytest.raises(ValueError, match="multiples of 128"):
        flash.flash_attention(q, k, v)


def test_flash_attention_wrapper_rejects_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _case(3, 1, 2, 2, 128, 128, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("dtype,d,path", [
    (torch.bfloat16, 64, "tensor_cores"),
    (torch.bfloat16, 128, "tensor_cores"),
    (torch.float16, 64, "tensor_cores"), (torch.float16, 128, "tensor_cores"),
    (torch.bfloat16, 32, "cuda_cores"), (torch.float16, 256, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores")])
def test_flash_attention_kernel_path_by_dtype_and_head_dim(dtype, d, path):
    """Which kernel a CUDA call launches depends on dtype and D only."""
    assert flash.kernel_path(dtype, d) == path
