"""The port's serving path against the JAX package, for every architecture
(reduced config, float32 weights made by the reference's ``init_params``
and carried over by ``convert.lm_params_to_torch``):

* prefill, then 3 greedy decode steps: the greedy tokens equal, the logits
  within rtol = atol = 2e-3, and the caches too.  Each decode step is held
  twice: the port's step from the reference's cache before that step (so
  one step is compared from one state), and the port's own chain from its
  own prefill (what a server runs);
* a prefill of one package decoded in the other: the reference's first
  step from the port's prefill cache;
* the ``serve`` CLI with ``--device cpu``, and without ``--device`` where
  there is no card.

The caches are bfloat16 (the reference's ``init_cache`` default, whatever
the weights), so a cache value that the two packages compute within 2e-3
in float32 can round to neighbouring bfloat16 values: a bfloat16 leaf is
held to rtol = atol = 2e-3 or one bfloat16 step (at most 2^-7 |want|).
Float32 leaves (the SSM state, the cross-attention k/v) are held to
rtol = atol = 2e-3 alone.
"""
import re

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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import Model, decode_step, prefill  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)
BF16_STEP = 2.0 ** -7
PROMPT, STEPS, BATCH = 16, 3, 2


def assert_tree_close(got, want, what: str) -> None:
    """``got`` (the port's cache in the reference's layout, NumPy) against
    ``want`` (the reference's, jax arrays): see the module docstring."""
    paths = jax.tree_util.tree_flatten_with_path(want)[0]
    leaves = jax.tree.leaves(got)
    assert len(paths) == len(leaves), what
    for (path, w), g in zip(paths, leaves):
        name = f"{what}{jax.tree_util.keystr(path)}"
        wf = np.asarray(w, np.float32)
        assert g.shape == wf.shape, name
        if w.dtype == jnp.bfloat16:
            d = np.abs(g - wf)
            ok = (d <= TOL["atol"] + TOL["rtol"] * np.abs(wf)) | \
                 (d <= BF16_STEP * np.abs(wf))
            assert ok.all(), (name, float(d[~ok].max()), int((~ok).sum()))
        else:
            np.testing.assert_allclose(g, wf, **TOL, err_msg=name)


def _as_ref(tree, template):
    """A NumPy cache from ``lm_cache_to_numpy`` in the reference's dtypes."""
    return jax.tree.map(lambda a, t: jnp.asarray(a, t.dtype), tree, template)


def _setup(arch):
    cfg, jcfg = reduced_config(arch), ref_reduced_config(arch)
    params = ref_model.init_params(jcfg, jax.random.key(0),
                                   dtype=jnp.float32)
    model = Model(cfg, dtype=torch.float32, device="cpu")
    convert.lm_params_to_torch(cfg, jax.tree.map(np.asarray, params), model)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(1, cfg.vocab,
                                    (BATCH, PROMPT)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend"] = rng.normal(
            0, 1, (BATCH, 8, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frontend"] = rng.normal(
            0, 1, (BATCH, 32, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, params, model, batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    cfg, jcfg, params, model, batch = _setup(arch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    s0 = serve.prompt_positions(cfg, tbatch)
    s_max = s0 + STEPS + 1
    ref_prefill = jax.jit(
        lambda p, b: ref_model.prefill(jcfg, p, b, s_max=s_max))
    ref_decode = jax.jit(
        lambda p, c, t, pos: ref_model.decode_step(jcfg, p, c, t, pos))

    jl, jc = ref_prefill(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    tl, own = prefill(cfg, model, tbatch, s_max=s_max)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    port_prefill_cache = convert.lm_cache_to_numpy(cfg, own)
    assert_tree_close(port_prefill_cache, jc, "prefill cache")

    # The reference decodes the port's prefill.
    tok0 = jnp.argmax(jl, -1).astype(jnp.int32)
    crossed, _ = ref_decode(params, _as_ref(port_prefill_cache, jc), tok0,
                            jnp.asarray(s0, jnp.int32))
    want0, _ = ref_decode(params, jc, tok0, jnp.asarray(s0, jnp.int32))
    np.testing.assert_allclose(np.asarray(crossed), np.asarray(want0), **TOL)

    chain = tl
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        np.testing.assert_array_equal(chain.argmax(-1).numpy(), tok)
        pos = s0 + i
        # The port's step from the reference's state (its prefill's at
        # step 0: the port decodes the reference's prefill).
        shared = convert.lm_cache_to_torch(cfg, jc, "cpu")
        tl1, shared = decode_step(cfg, model, shared, torch.from_numpy(tok),
                                  pos)
        jl, jc = ref_decode(params, jc, jnp.asarray(tok),
                            jnp.asarray(pos, jnp.int32))
        np.testing.assert_allclose(tl1.numpy(), np.asarray(jl), **TOL)
        assert_tree_close(convert.lm_cache_to_numpy(cfg, shared), jc,
                          f"step {i} cache")
        chain, own = decode_step(cfg, model, own, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(chain.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(chain.argmax(-1).numpy(),
                                  np.asarray(jnp.argmax(jl, -1)))
    assert_tree_close(convert.lm_cache_to_numpy(cfg, own), jc, "own cache")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_on_cpu(arch, capsys):
    res = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"prefill 2x16 in \d+\.\d\ds; decoded 4 tokens in "
                        r"\d+\.\d\ds \(\d+\.\d tok/s\)", out[0]), out
    assert out[1].startswith("sample: [")
    assert out[2] == "device: cpu (cpu)"
    cfg = reduced_config(arch)
    assert res["tokens"].shape == (2, 4)
    assert ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab)).all()
    assert res["prefill_logits"].shape == (2, cfg.padded_vocab())
    # The CLI's tokens are the greedy chain of its own weights and prompt.
    model = Model(cfg, device="cpu", seed=0)
    batch = serve.make_batch(cfg, 2, 16, 0, "cpu")
    again = serve.serve(cfg, model, batch, 4, s_max=16 + 4 + 8)
    np.testing.assert_array_equal(again["tokens"], res["tokens"])


def test_serve_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen2-1.5b", "--reduced"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_float32_cache(arch):
    """``cache_dtype=torch.float32`` (chip_smoke.py phase 12 (c)) keeps
    every cache value unrounded: the same prefill logits (prefill never
    reads its cache), every cache tensor float32 and, rounded to
    bfloat16, equal to the default cache."""
    cfg = reduced_config(arch)
    model = Model(cfg, dtype=torch.float32, device="cpu", seed=3)
    batch = serve.make_batch(cfg, 2, 16, 3, "cpu")
    want, c16 = prefill(cfg, model, batch, s_max=32)
    got, c32 = prefill(cfg, model, batch, s_max=32,
                       cache_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(c32["layers"] + c32.get("cross", []),
                    c16["layers"] + c16.get("cross", [])):
        for k in b:
            assert a[k].dtype == torch.float32
            torch.testing.assert_close(a[k].to(b[k].dtype), b[k],
                                       rtol=0, atol=0)


def test_vision_prefix_decode_position():
    """The reference's fault 8 (ROADMAP, queue 3): its ``launch/serve.py``
    decodes a vision request's token i at ``prompt_len + i``, though the 8
    stub embeddings take the cache's first positions, so its first step
    overwrites a prompt token's cached key.  The port's ``serve`` decodes
    at the prefix's length plus the prompt's: every prompt key stays."""
    cfg, jcfg, params, model, batch = _setup("internvl2-26b")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    s0 = serve.prompt_positions(cfg, tbatch)
    assert s0 == PROMPT + 8
    jl, jc = ref_model.prefill(jcfg, params, {k: jnp.asarray(v)
                                              for k, v in batch.items()},
                               s_max=s0 + 4)
    tok = jnp.argmax(jl, -1).astype(jnp.int32)
    before = np.asarray(jc["period"][0]["k"][0], np.float32)
    _, after = ref_model.decode_step(jcfg, params, jc, tok,
                                     jnp.asarray(PROMPT, jnp.int32))
    after = np.asarray(after["period"][0]["k"][0], np.float32)
    assert not np.array_equal(after[:, PROMPT], before[:, PROMPT])
    tl, tc = prefill(cfg, model, tbatch, s_max=s0 + 4)
    keys = tc["layers"][0]["k"].clone()
    decode_step(cfg, model, tc, tl.argmax(-1), s0)
    torch.testing.assert_close(tc["layers"][0]["k"][:, :s0], keys[:, :s0],
                               rtol=0, atol=0)
    assert not torch.equal(tc["layers"][0]["k"][:, s0], keys[:, s0])


def test_phase12_rehearsal_on_cpu():
    """``chip_smoke.py``'s phase 12 at reduced width on the CPU: both
    requests served, checks (a), (b) and (d)'s comparison with the model's
    attention pass, and (c)'s code runs (the CPU against itself)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.serving_path(torch.device("cpu"), 0, reduced=True,
                             log=lambda *a: None)
    assert out["A"]["attention"] == "full" and out["B"]["gen"] == 2
    assert out["decode_vs_prefill_max_abs_err"] < 2e-2
    assert out["bf16_vs_f32_rel_l1"] < smoke.SERVE_BF16_L1
    assert out["attention"]["rel_l1_vs_model"] < smoke.SERVE_ATTN_L1
    assert smoke.check_family_on_card("jamba-v0.1-52b",
                                      torch.device("cpu"), 0) == 0.0
