"""The port's training loss and its gradients against the JAX package's
``jax.value_and_grad(repro.models.loss)``, for every architecture (reduced
config, float32 weights made by the reference's ``init_params`` and carried
over by ``convert.lm_params_to_torch``; the port's gradients restacked into
the reference's tree by ``convert.lm_params_to_numpy``).  The vision
prefix (internvl2) and the encoder frames (whisper) are in the batches.

Tolerances: the loss within rtol 1e-5; every gradient leaf within rtol
1e-4 and atol 1e-4 x the leaf's largest |g| (a parameter no path reads,
such as whisper's ``cross_norm``, is zeros on both sides).  Remat (the
full configs' ``cfg.remat``, per layer, and ``remat_policy="dots"``)
changes no bit of the port's gradients.  With bfloat16 weights the loss is
held within 1e-2 of the reference's bfloat16 loss.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import reduced_config as ref_reduced_config  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.models import Model, loss  # noqa: E402

B, S = 2, 32
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


def make_batch(cfg, seed=1, targets=True):
    """Tokens and next-token targets of one row of S + 1 tokens, and for a
    frontend float32 stub embeddings (8 patches, 32 frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1]}
    if targets:
        batch["targets"] = toks[:, 1:]
    if cfg.frontend == "vision":
        batch["frontend"] = rng.normal(0, 1, (B, 8, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["frontend"] = rng.normal(0, 1, (B, 32, cfg.d_model)).astype(
            np.float32)
    return batch


def setup(arch, dtype=jnp.float32, **replace):
    cfg = dataclasses.replace(reduced_config(arch), **replace)
    jcfg = dataclasses.replace(ref_reduced_config(arch), **replace)
    params = ref_model.init_params(jcfg, jax.random.key(0), dtype=dtype)
    model = Model(cfg, dtype=torch.float32 if dtype == jnp.float32
                  else torch.bfloat16, device="cpu")
    convert.lm_params_to_torch(cfg, jax.tree.map(np.asarray, params), model)
    return cfg, jcfg, params, model


def ref_value_and_grad(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_model.loss(jcfg, p, b)))
    return fn(params, {k: jnp.asarray(v) for k, v in batch.items()})


def port_value_and_grad(cfg, model, batch):
    """-> (loss, gradients by parameter name; None where no path reads
    the parameter)."""
    tl = loss(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, ps = zip(*model.named_parameters())
    gs = torch.autograd.grad(tl, ps, allow_unused=True)
    return tl.detach(), dict(zip(names, gs))


def assert_grads_close(cfg, model, grads, want):
    got = convert.lm_params_to_numpy(cfg, model, grads)
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = jax.tree.leaves(got)
    assert len(paths) == len(leaves)
    for (path, w), g in zip(paths, leaves):
        name = jax.tree_util.keystr(path)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * float(np.abs(w).max()),
            err_msg=name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    cfg, jcfg, params, model = setup(arch)
    batch = make_batch(cfg)
    jl, jg = ref_value_and_grad(jcfg, params, batch)
    tl, grads = port_value_and_grad(cfg, model, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_grads_close(cfg, model, grads, jg)
    # Autograd leaves out only parameters no path reads: whisper's
    # cross_norm and the SSM layers' unused norm2.
    unused = {k for k, g in grads.items() if g is None}
    assert all(k.startswith("cross_norm.") or k.endswith("norm2.scale")
               for k in unused), unused


def test_loss_without_targets_shifts_tokens():
    """No ``targets``: the tokens shifted by one with a 0 last, and the
    last position still masked (the reference's rule)."""
    cfg, jcfg, params, model = setup("qwen2-1.5b")
    batch = make_batch(cfg, targets=False)
    jl, jg = ref_value_and_grad(jcfg, params, batch)
    tl, grads = port_value_and_grad(cfg, model, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_grads_close(cfg, model, grads, jg)
    # Given explicitly, the same targets give the same loss.
    shifted = dict(batch, targets=np.concatenate(
        [batch["tokens"][:, 1:], np.zeros((B, 1), np.int32)], 1))
    np.testing.assert_array_equal(
        port_value_and_grad(cfg, model, shifted)[0].numpy(), tl.numpy())


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b"])
def test_remat_changes_no_bit(arch):
    """Remat on (each period layer checkpointed; jamba's period has 8
    layers) against off: bit-equal loss and gradients in the port, and
    equal to the reference's remat run within the tolerances."""
    cfg, jcfg, params, model = setup(arch, remat=True)
    batch = make_batch(cfg)
    tl, grads = port_value_and_grad(cfg, model, batch)
    plain = dataclasses.replace(cfg, remat=False)
    pl, pgrads = port_value_and_grad(plain, model, batch)
    np.testing.assert_array_equal(tl.numpy(), pl.numpy())
    for k, g in grads.items():
        if g is None:
            assert pgrads[k] is None, k
        else:
            assert torch.equal(g, pgrads[k]), k
    jl, jg = ref_value_and_grad(jcfg, params, batch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert_grads_close(cfg, model, grads, jg)


def test_remat_dots_policy_changes_no_bit():
    """``remat_policy="dots"`` (the matrix products' outputs kept, the rest
    recomputed) on whisper, whose encoder layers are checkpointed too."""
    cfg, _, _, model = setup("whisper-small", remat=True,
                             remat_policy="dots")
    batch = make_batch(cfg)
    tl, grads = port_value_and_grad(cfg, model, batch)
    pl, pgrads = port_value_and_grad(
        dataclasses.replace(cfg, remat=False), model, batch)
    np.testing.assert_array_equal(tl.numpy(), pl.numpy())
    for k, g in grads.items():
        assert (g is None and pgrads[k] is None) or torch.equal(
            g, pgrads[k]), k


def test_bf16_loss_matches_reference_bf16():
    cfg, jcfg, params, model = setup("qwen2-1.5b", dtype=jnp.bfloat16)
    batch = make_batch(cfg)
    jl, _ = ref_value_and_grad(jcfg, params, batch)
    tl, grads = port_value_and_grad(cfg, model, batch)
    assert abs(float(tl) - float(jl)) < 1e-2
    assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all()
               for g in grads.values())
