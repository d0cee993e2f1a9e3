"""The port's MoE dispatch and SSD block against the JAX package on the CPU,
float32 weights made by the reference's ``init_moe``/``init_ssm`` and
carried by ``convert.lm_module_params_to_torch``.

* ``expert_capacity`` equal;
* ``moe_apply`` for the dense-residual (Arctic), shared-expert
  (DeepSeek-V2) and Jamba layers, and with capacity drops (capacity factor
  0.1): the expert ids and the dispatch's slot tables (the token in each
  slot, byte-equal; its bfloat16 gate within one bfloat16 step) as the
  reference computes them (``moe.py:89-121``, re-derived here with its own
  ``jax.lax.top_k``, stable ``argsort`` and ``mode="drop"`` scatters), the
  output within rtol = atol = 2e-3;
* ``aux_load_balance_loss`` within 1e-5;
* ``ssd_train`` on a ragged length (padded to a chunk multiple) and, with
  its state, on a chunk multiple; then 4 ``ssm_decode`` steps from that
  state: outputs and float32 state within rtol = atol = 2e-3, the bfloat16
  conv tail as in ``test_torch_serve.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.layers import linear as ref_linear  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers, moe, ssm  # noqa: E402

from test_torch_serve import TOL, assert_tree_close  # noqa: E402

CPU = layers.Init(torch.float32, torch.device("cpu"), None)


def _module(arch, init_fn, cls, moe_changes=None):
    cfg, jcfg = configs.reduced_config(arch), ref_configs.reduced_config(arch)
    if moe_changes:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_changes))
    p = init_fn(jax.random.key(0), jcfg, dtype=jnp.float32)
    mod = cls(cfg, CPU)
    convert.lm_module_params_to_torch(jax.tree.map(np.asarray, p), mod)
    return cfg, jcfg, p, mod


def _x(d, b, s, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(0, 1, (b, s, d))
         * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("n", [1, 2, 8, 64, 100, 4096])
def test_expert_capacity(n):
    for arch in ("arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b"):
        for override in (0.0, 0.5, 3.0):
            assert moe.expert_capacity(
                n, configs.get_config(arch).moe, override) == \
                ref_moe.expert_capacity(
                    n, ref_configs.get_config(arch).moe, override)


def _ref_dispatch(p, xt, jcfg, capg):
    """The reference's routing and slot tables (``moe.py:89-121``) for one
    group of tokens ``xt`` [T, d]."""
    m = jcfg.moe
    t = xt.shape[0]
    logits = ref_linear(p["router"], xt.astype(jnp.float32))
    gates, ids = jax.lax.top_k(jax.nn.softmax(logits, -1), m.top_k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    e_flat = ids.reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    rank = jnp.arange(t * m.top_k) - jnp.searchsorted(e_sorted, e_sorted,
                                                      side="left")
    slot = jnp.where(rank < capg, e_sorted * capg + rank, m.n_experts * capg)
    tok = jnp.repeat(jnp.arange(t, dtype=jnp.int32), m.top_k)[order]
    idx = jnp.full((m.n_experts * capg,), t, jnp.int32).at[slot].set(
        tok, mode="drop")
    gts = jnp.zeros((m.n_experts * capg,), jnp.bfloat16).at[slot].set(
        gates.reshape(-1)[order].astype(jnp.bfloat16), mode="drop")
    return ids, idx, gts, int(jnp.sum(rank >= capg))


@torch.no_grad()
@pytest.mark.parametrize("arch,changes", [
    ("arctic-480b", None), ("deepseek-v2-236b", None),
    ("jamba-v0.1-52b", None), ("arctic-480b", {"capacity_factor": 0.1})])
def test_moe_apply_matches_reference(arch, changes):
    cfg, jcfg, p, mod = _module(arch, ref_moe.init_moe, moe.MoE, changes)
    jx, tx = _x(cfg.d_model, 2, 32, seed=1)
    capg = moe.expert_capacity(64, cfg.moe)
    ids, idx, gts, dropped = _ref_dispatch(p, jx.reshape(64, -1), jcfg, capg)
    assert (dropped > 0) == bool(changes)
    gates, tids, _ = mod.route(tx.reshape(64, -1))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    tidx, tgts = mod.dispatch(tids, gates, capg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    _gts = np.asarray(gts, np.float32)
    d = np.abs(tgts.float().numpy() - _gts)
    assert (d <= 2.0 ** -7 * _gts).all(), float(d.max())
    want = ref_moe.moe_apply(p, jx, jcfg)
    got = moe.moe_apply(mod, tx, cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        float(moe.aux_load_balance_loss(mod, tx, cfg)),
        float(ref_moe.aux_load_balance_loss(p, jx, jcfg)),
        rtol=1e-5, atol=1e-5)


@torch.no_grad()
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_ssd_and_decode_match_reference(arch):
    cfg, jcfg, p, mod = _module(arch, ref_ssm.init_ssm, ssm.SSM)
    chunk = cfg.ssm.chunk
    # A ragged length: padded to a chunk multiple, no state.
    jx, tx = _x(cfg.d_model, 2, 3 * chunk - 3, seed=2, scale=0.3)
    got = ssm.ssd_train(mod, tx, cfg)
    with pytest.raises(ValueError, match="chunk multiple"):
        ssm.ssd_train(mod, tx, cfg, return_state=True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref_ssm.ssd_train(p, jx, jcfg)),
                               **TOL)
    # A chunk multiple with its state, then the recurrent decode.
    jx, tx = _x(cfg.d_model, 2, 3 * chunk + 4, seed=3, scale=0.3)
    n = 3 * chunk
    got, st = ssm.ssd_train(mod, tx[:, :n], cfg, return_state=True)
    want, jst = ref_ssm.ssd_train(p, jx[:, :n], jcfg, return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_tree_close({k: convert.to_numpy(v) for k, v in st.items()}, jst,
                      "ssd state")
    for t in range(n, n + 4):
        want, jst = ref_ssm.ssm_decode(p, jx[:, t:t + 1], jst, jcfg)
        got, st = ssm.ssm_decode(mod, tx[:, t:t + 1], st, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_tree_close({k: convert.to_numpy(v) for k, v in st.items()},
                          jst, f"decode state {t}")
    zeros = ssm.init_ssm_state(cfg, 3, device="cpu")
    ref_zeros = ref_ssm.init_ssm_state(jcfg, 3)
    for k in ("h", "conv"):
        assert tuple(zeros[k].shape) == ref_zeros[k].shape
        assert str(zeros[k].dtype).split(".")[1] == ref_zeros[k].dtype.name
