"""The port's configs and layers against the JAX package on the CPU.

* configs: every field of the full and reduced config of each of the ten
  architectures, both parameter counts, the padded vocab, the per-layer
  attention/MoE predicates, ``SHAPES`` and ``shape_applicable``, equal;
* ``plan_layers`` equal, full and reduced;
* RoPE, RMSNorm, LayerNorm and ``full_attention`` on the same inputs:
  float32 within rtol = atol = 1e-5, bfloat16 within one bfloat16 step
  (at most 2^-7 |want|) or 1e-5;
* ``chunked_attention`` and ``mla_latent_chunked_attention`` with
  ``_CHUNK`` set small in both packages (keys padded to a chunk multiple,
  the reference's unrolled and scanned loops), and ``attention_any``'s
  switch at 8,192 keys: within rtol = atol = 1e-5;
* the GQA block (prefill and the ring-buffer decode), the MLA block
  (prefill and the absorbed decode) and cross attention, float32 weights
  carried by ``convert.lm_module_params_to_torch``: within rtol = atol =
  2e-3 (the serving tolerance), caches as in ``test_torch_serve.py``;
* the SWA ring on reduced h2o-danube with a 16-token window, a 40-token
  prompt and 4 decode steps (the prefill keeps the last 16 keys rolled to
  slot = pos % 16).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import Model, decode_step, prefill  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.model import plan_layers  # noqa: E402

from test_torch_serve import TOL, assert_tree_close  # noqa: E402

TIGHT = dict(rtol=1e-5, atol=1e-5)
CPU = layers.Init(torch.float32, torch.device("cpu"), None)


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, **tol):
    want = np.asarray(want, np.float32)
    got = _np(got)
    d = np.abs(got - want)
    ok = (d <= tol["atol"] + tol["rtol"] * np.abs(want)) | \
         (d <= 2.0 ** -7 * np.abs(want))
    assert ok.all(), float(d[~ok].max())


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for get in ("get_config", "reduced_config"):
        c = getattr(configs, get)(arch)
        r = getattr(ref_configs, get)(arch)
        assert dataclasses.asdict(c) == dataclasses.asdict(r)
        assert (c.param_count(), c.active_param_count(), c.hd,
                c.padded_vocab(), c.padded_vocab(128)) == (
            r.param_count(), r.active_param_count(), r.hd,
            r.padded_vocab(), r.padded_vocab(128))
        for i in range(c.n_layers):
            assert c._is_attn_layer(i) == r._is_attn_layer(i)
            assert c._is_moe_layer(i) == r._is_moe_layer(i)
        for s, rs in zip(configs.SHAPES, ref_configs.SHAPES):
            assert dataclasses.asdict(s) == dataclasses.asdict(rs)
            assert configs.shape_applicable(c, s) == \
                ref_configs.shape_applicable(r, rs)
            assert configs.get_shape(s.name) == s


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plan_layers_equal(arch):
    for get in ("get_config", "reduced_config"):
        prefix, period, n = plan_layers(getattr(configs, get)(arch))
        rp, rper, rn = ref_model.plan_layers(getattr(ref_configs, get)(arch))
        assert ([tuple(d) for d in prefix], [tuple(d) for d in period], n) \
            == ([tuple(d) for d in rp], [tuple(d) for d in rper], rn)


# ------------------------------------------------------ rope, norms, attn --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_norms(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 12, 3, 32)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = convert.array_to_torch(np.asarray(jx), "cpu")
    tol = TIGHT
    pos = np.arange(12, dtype=np.int32)
    for theta in (1e4, 1e6):
        _close(layers.apply_rope(tx, torch.from_numpy(pos), theta),
               ref_layers.apply_rope(jx, jnp.asarray(pos), theta), **tol)
        # Decode's one position.
        _close(layers.apply_rope(tx[:, :1], torch.tensor([37]), theta),
               ref_layers.apply_rope(jx[:, :1], jnp.asarray([37]), theta),
               **tol)
    scale = rng.normal(1, 0.1, (32,)).astype(np.float32)
    bias = rng.normal(0, 0.1, (32,)).astype(np.float32)
    js, jb = jnp.asarray(scale, dtype), jnp.asarray(bias, dtype)
    ts = convert.array_to_torch(np.asarray(js), "cpu")
    tb = convert.array_to_torch(np.asarray(jb), "cpu")
    for eps in (1e-5, 1e-6):
        _close(layers.rmsnorm(ts, tx, eps),
               ref_layers.rmsnorm({"scale": js}, jx, eps), **tol)
        ln = layers.LayerNorm(32, CPU._replace(dtype=ts.dtype))
        with torch.no_grad():
            ln.scale.copy_(ts)
            ln.bias.copy_(tb)
        _close(ln(tx, eps),
               ref_layers.layernorm({"scale": js, "bias": jb}, jx, eps),
               **tol)


def _qkv(rng, b, sq, skv, hq, hkv, d, dtype="float32"):
    q = rng.normal(0, 1, (b, sq, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, skv, hkv, d)).astype(np.float32)
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    t = [convert.array_to_torch(np.asarray(a), "cpu") for a in j]
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 7)])
def test_full_attention(dtype, causal, window):
    rng = np.random.default_rng(1)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, 20, 20, 6, 2, 16, dtype)
    pos = np.arange(20, dtype=np.int32)
    kw = dict(causal=causal, window=window, scale=16 ** -0.5)
    got = layers.full_attention(tq, tk, tv, torch.from_numpy(pos),
                                torch.from_numpy(pos), **kw)
    want = ref_layers.full_attention(jq, jk, jv, jnp.asarray(pos),
                                     jnp.asarray(pos), **kw)
    assert str(got.dtype).endswith(dtype)
    _close(got, want, **TIGHT)


@pytest.mark.parametrize("skv,chunk", [(40, 16), (160, 8)])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 9)])
def test_chunked_attention(monkeypatch, skv, chunk, causal, window):
    """Keys padded to a chunk multiple (40 over 16), and more than 16
    chunks (160 over 8: the reference scans instead of unrolling)."""
    monkeypatch.setattr(ref_layers, "_CHUNK", chunk)
    monkeypatch.setattr(layers, "_CHUNK", chunk)
    rng = np.random.default_rng(2)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, skv, skv, 4, 2, 8)
    pos = np.arange(skv, dtype=np.int32)
    kw = dict(causal=causal, window=window, scale=0.3)
    got = layers.chunked_attention(tq, tk, tv, torch.from_numpy(pos),
                                   torch.from_numpy(pos), **kw)
    want = ref_layers.chunked_attention(jq, jk, jv, jnp.asarray(pos),
                                        jnp.asarray(pos), **kw)
    _close(got, want, **TIGHT)
    # The chunked and the full path agree with each other too.
    full = layers.full_attention(tq, tk, tv, torch.from_numpy(pos),
                                 torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(full), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("skv", [8192, 8193])
def test_attention_any_switch(monkeypatch, skv):
    taken = []
    real = layers.chunked_attention

    def spy(*a, **kw):
        taken.append("chunked")
        return real(*a, **kw)

    monkeypatch.setattr(layers, "chunked_attention", spy)
    rng = np.random.default_rng(3)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 4, skv, 2, 1, 8)
    qpos = np.arange(skv - 4, skv, dtype=np.int32)
    kpos = np.arange(skv, dtype=np.int32)
    kw = dict(causal=True, window=0, scale=0.35)
    got = layers.attention_any(tq, tk, tv, torch.from_numpy(qpos),
                               torch.from_numpy(kpos), **kw)
    want = ref_layers.attention_any(jq, jk, jv, jnp.asarray(qpos),
                                    jnp.asarray(kpos), **kw)
    assert taken == (["chunked"] if skv > 8192 else [])
    _close(got, want, **TIGHT)


def test_mla_latent_chunked_attention(monkeypatch):
    monkeypatch.setattr(ref_layers, "_CHUNK", 16)
    monkeypatch.setattr(layers, "_CHUNK", 16)
    rng = np.random.default_rng(4)
    b, s, h, nope, rope, c, vd = 2, 40, 4, 8, 4, 12, 6
    arrs = [rng.normal(0, 1, shape).astype(np.float32) for shape in (
        (b, s, h, nope + rope), (b, s, c), (b, s, rope), (c, h, nope),
        (c, h, vd))]
    kw = dict(scale=(nope + rope) ** -0.5, h=h, qk_nope=nope, v_dim=vd)
    got = layers.mla_latent_chunked_attention(
        *(torch.from_numpy(a) for a in arrs), **kw)
    want = ref_layers.mla_latent_chunked_attention(
        *(jnp.asarray(a) for a in arrs), **kw)
    _close(got, want, **TIGHT)


# ------------------------------------------------------------------ blocks --
def _block(arch, init_fn, cls, **changes):
    cfg = dataclasses.replace(configs.reduced_config(arch), **changes)
    jcfg = dataclasses.replace(ref_configs.reduced_config(arch), **changes)
    p = init_fn(jax.random.key(0), jcfg, dtype=jnp.float32)
    mod = cls(cfg, CPU)
    convert.lm_module_params_to_torch(jax.tree.map(np.asarray, p), mod)
    return cfg, jcfg, p, mod


def _x(cfg, b, s, seed=5):
    x = np.random.default_rng(seed).normal(
        0, 1, (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("arch,swa", [("qwen2-1.5b", 0),
                                      ("h2o-danube-3-4b", 16)])
def test_gqa_block_and_decode(arch, swa):
    cfg, jcfg, p, mod = _block(arch, ref_layers.init_gqa, layers.GQA,
                               swa_window=swa)
    jx, tx = _x(cfg, 2, 24)
    want, kv = ref_layers.gqa_train(p, jx, jcfg, return_kv=True)
    got, tkv = mod(tx, return_kv=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tkv[k]), np.asarray(kv[k]), **TOL)
    want_nc = ref_layers.gqa_train(p, jx, jcfg, causal=False)
    np.testing.assert_allclose(_np(mod(tx, causal=False)),
                               np.asarray(want_nc), **TOL)
    # Decode from a random bfloat16 cache; with a window the ring wraps.
    w = 16 if swa else 48
    rng = np.random.default_rng(6)
    cache = {k: jnp.asarray(rng.normal(0, 1, (2, w, cfg.n_kv_heads, cfg.hd)),
                            jnp.bfloat16) for k in ("k", "v")}
    tcache = {k: convert.array_to_torch(np.asarray(v), "cpu")
              for k, v in cache.items()}
    for pos in (0, 5, 37):
        jx1, tx1 = _x(cfg, 2, 1, seed=pos)
        want, cache = ref_layers.gqa_decode(p, jx1, cache,
                                            jnp.asarray(pos, jnp.int32), jcfg)
        got, tcache = layers.gqa_decode(mod, tx1, tcache, pos, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert_tree_close({k: convert.to_numpy(v)
                           for k, v in tcache.items()}, cache,
                          f"gqa decode {pos}")


def test_mla_block_and_decode():
    cfg, jcfg, p, mod = _block("deepseek-v2-236b", ref_layers.init_mla,
                               layers.MLA)
    jx, tx = _x(cfg, 2, 20)
    want = ref_layers.mla_train(p, jx, jcfg)
    got, lat = mod(tx, return_cache=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    m = cfg.mla
    rng = np.random.default_rng(7)
    cache = {"ckv": jnp.asarray(rng.normal(0, 1, (2, 24, m.kv_lora)),
                                jnp.bfloat16),
             "kr": jnp.asarray(rng.normal(0, 1, (2, 24, m.qk_rope)),
                               jnp.bfloat16)}
    tcache = {k: convert.array_to_torch(np.asarray(v), "cpu")
              for k, v in cache.items()}
    for pos in (0, 11, 23):
        jx1, tx1 = _x(cfg, 2, 1, seed=pos)
        want, cache = ref_layers.mla_decode(p, jx1, cache,
                                            jnp.asarray(pos, jnp.int32), jcfg)
        got, tcache = layers.mla_decode(mod, tx1, tcache, pos, cfg)
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
        assert_tree_close({k: convert.to_numpy(v)
                           for k, v in tcache.items()}, cache,
                          f"mla decode {pos}")


def test_cross_attention():
    cfg, jcfg, p, mod = _block("whisper-small", ref_layers.init_gqa,
                               layers.GQA)
    jm, tm = _x(cfg, 2, 12, seed=8)
    jx, tx = _x(cfg, 2, 5, seed=9)
    kv = ref_layers.cross_kv(p, jm, jcfg)
    tkv = layers.cross_kv(mod, tm, cfg)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(tkv[k]), np.asarray(kv[k]), **TOL)
    np.testing.assert_allclose(
        _np(layers.cross_attention(mod, tx, tkv, cfg)),
        np.asarray(ref_layers.cross_attention(p, jx, kv, jcfg)), **TOL)


def test_swa_ring_prefill_and_decode():
    """Reduced h2o-danube with a 16-token window: a 40-token prompt leaves
    the last 16 keys in the cache, rolled so slot = pos % 16; then 4
    decode steps wrap the ring."""
    cfg = dataclasses.replace(configs.reduced_config("h2o-danube-3-4b"),
                              swa_window=16)
    jcfg = dataclasses.replace(
        ref_configs.reduced_config("h2o-danube-3-4b"), swa_window=16)
    params = ref_model.init_params(jcfg, jax.random.key(0),
                                   dtype=jnp.float32)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    convert.lm_params_to_torch(cfg, jax.tree.map(np.asarray, params), model)
    toks = np.random.default_rng(10).integers(
        1, cfg.vocab, (2, 40)).astype(np.int32)
    jl, jc = ref_model.prefill(jcfg, params, {"tokens": jnp.asarray(toks)},
                               s_max=44)
    tl, tc = prefill(cfg, model, {"tokens": torch.from_numpy(toks)},
                     s_max=44)
    assert tc["layers"][0]["k"].shape[1] == 16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_tree_close(convert.lm_cache_to_numpy(cfg, tc), jc, "ring prefill")
    decode = jax.jit(lambda p, c, t, pos: ref_model.decode_step(
        jcfg, p, c, t, pos))
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), tok)
        jl, jc = decode(params, jc, jnp.asarray(tok),
                        jnp.asarray(40 + i, jnp.int32))
        tl, tc = decode_step(cfg, model, tc, torch.from_numpy(tok), 40 + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert_tree_close(convert.lm_cache_to_numpy(cfg, tc), jc,
                          f"ring step {i}")
