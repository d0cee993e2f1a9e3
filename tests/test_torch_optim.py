"""The port's optimizer substrate (``repro_torch.optim`` and
``launch.train.make_train_step``) against the JAX package's.

* ``adamw_update``: three steps on the reduced model's real gradients (the
  reference's, carried over), float32 and bfloat16 parameters.  Float32
  parameters and every (float32) moment within 1e-6 (relative, and
  absolute x the leaf's largest value); a bfloat16 parameter within one
  bfloat16 step of the reference's.  Whisper's ``cross_norm``, which no
  path reads, has no gradient in the port (``None``) and a zero leaf in
  the reference: it decays the same.
* ``cosine_schedule`` at steps 0, 50, 100, 5,000, 10,000 and 20,000
  (rtol 1e-6; exactly 0 at step 0).
* ``accumulate_grads`` with 1, 2 and 4 micro-batches (the loss within
  rtol 1e-5, gradients as ``test_torch_train.py`` holds them).
* ``make_train_step``: three steps from the same weights and pipeline.
* ``compress_int8`` / ``decompress_int8`` byte-equal; ``compression_ratio``
  equal.
* ``compressed_psum_cb`` over 4 gloo ranks against the reference under
  ``shard_map`` on 4 host devices (``slow``; each package in a subprocess
  of its own): two steps, the second fed the first's residuals.  The first
  step's means are byte-equal.  The residuals are not: XLA contracts
  ``g_ef - q * scale`` into one fused multiply-add, where the port rounds
  the product first, so a residual may differ by the rounding of that
  product, at most 2^-24 of the leaf's largest |g|; the residuals and the
  second step's means (which read them) are held within 2^-21 of it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.launch.train import make_train_step as ref_make_train_step  # noqa: E402,E501
from repro.models import model as ref_model  # noqa: E402
from repro.optim import accumulation as ref_acc  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import grad_compress as ref_gc  # noqa: E402
from repro.optim import schedule as ref_sched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.data.pipeline import TokenPipeline  # noqa: E402
from repro_torch.launch.train import make_train_step, to_device  # noqa: E402
from repro_torch.models import loss  # noqa: E402
from repro_torch.optim import (accumulate_grads, adamw_init,  # noqa: E402
                               adamw_update, compress_int8, cosine_schedule,
                               decompress_int8)
from repro_torch.optim.grad_compress import compression_ratio  # noqa: E402

from test_torch_train import (assert_grads_close, make_batch,  # noqa: E402
                              setup)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
BF16_STEP = 2.0 ** -7


def _close(got, want, what, bf16=False):
    w = np.asarray(want, np.float32)
    g = np.asarray(got, np.float32)
    assert g.shape == w.shape, what
    d = np.abs(g - w)
    if bf16:
        ok = d <= BF16_STEP * np.abs(w)
    else:
        ok = d <= TOL * np.abs(w) + TOL * max(float(np.abs(w).max()), 1.0)
    assert ok.all(), (what, float(d.max()), int((~ok).sum()))


@pytest.mark.parametrize("arch,dtype", [("whisper-small", "float32"),
                                        ("qwen2-1.5b", "float32"),
                                        ("qwen2-1.5b", "bfloat16")])
def test_adamw_three_steps_match_reference(arch, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg, jcfg, params, model = setup(arch, dtype=jdt)
    batch = make_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jg = jax.value_and_grad(lambda p: ref_model.loss(jcfg, p, jb))(params)
    grads = convert.lm_tree_to_torch(cfg, jax.tree.map(np.asarray, jg), "cpu")
    # The parameters no path reads: None in the port, zeros in the
    # reference.
    tl = loss(cfg, model, {k: torch.from_numpy(v) for k, v in batch.items()})
    names, ps = zip(*model.named_parameters())
    for n, g in zip(names, torch.autograd.grad(tl, ps, allow_unused=True)):
        if g is None:
            assert not np.asarray(grads[n], np.float32).any(), n
            grads[n] = None
    if arch == "whisper-small":
        assert grads["cross_norm.scale"] is None
    ropt = ref_adamw.adamw_init(params)
    opt = adamw_init(model)
    lr = 1e-2
    for step in range(3):
        params, ropt = ref_adamw.adamw_update(params, jg, ropt, lr=lr)
        model, opt = adamw_update(model, grads, opt, lr=lr)
        assert int(opt.step) == int(ropt.step) == step + 1
        got = convert.lm_params_to_numpy(cfg, model)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(
                params)[0], jax.tree.leaves(got)):
            _close(g, w, f"step {step} {jax.tree_util.keystr(path)}",
                   bf16=dtype == "bfloat16")
        for name in ("m", "v"):
            mine = getattr(opt, name)
            assert all(t.dtype == torch.float32 for t in mine.values())
            got = convert.lm_params_to_numpy(cfg, model, mine)
            for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(
                    getattr(ropt, name))[0], jax.tree.leaves(got)):
                _close(g, w, f"step {step} {name}"
                       f"{jax.tree_util.keystr(path)}")
    if arch == "whisper-small":
        # The unread parameter decayed: 3 steps of p - lr * 0.1 * p.
        s = model.cross_norm.scale.detach()
        assert bool((s < 1.0).all())


def test_cosine_schedule_matches_reference():
    for step in (0, 50, 100, 5000, 10000, 20000):
        want = np.asarray(ref_sched.cosine_schedule(step))
        got = cosine_schedule(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=str(step))
        got_t = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                base_lr=1e-3, warmup=10, total=100)
        want_t = np.asarray(ref_sched.cosine_schedule(
            jnp.int32(step), base_lr=1e-3, warmup=10, total=100))
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6)
    assert float(cosine_schedule(0)) == 0.0


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_accumulate_grads_matches_reference(n_micro):
    cfg, jcfg, params, model = setup("qwen2-1.5b")
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jg = jax.jit(lambda p, b: ref_acc.accumulate_grads(
        lambda p_, b_: ref_model.loss(jcfg, p_, b_), p, b, n_micro))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, grads = accumulate_grads(
        lambda m, b: loss(cfg, m, b), model,
        {k: torch.from_numpy(v) for k, v in batch.items()}, n_micro)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert_grads_close(cfg, model, grads, jg)


def test_accumulate_grads_dtypes():
    """One micro-batch keeps the parameters' dtype; more accumulate in
    float32.  An unread parameter's gradient is zeros."""
    cfg, _, _, model = setup("whisper-small", dtype=jnp.bfloat16)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    fn = lambda m, b: loss(cfg, m, b)  # noqa: E731
    _, g1 = accumulate_grads(fn, model, batch, 1)
    _, g2 = accumulate_grads(fn, model, batch, 2)
    assert all(g.dtype == torch.bfloat16 for g in g1.values())
    assert all(g.dtype == torch.float32 for g in g2.values())
    assert not g1["cross_norm.scale"].any() and not g2["cross_norm.bias"].any()


@pytest.mark.parametrize("n_micro", [1, 2])
def test_make_train_step_matches_reference(n_micro):
    cfg, jcfg, params, model = setup("qwen2-1.5b")
    ropt = ref_adamw.adamw_init(params)
    opt = adamw_init(model)
    rstep = ref_make_train_step(jcfg, n_micro=n_micro, base_lr=1e-2)
    step = make_train_step(cfg, n_micro=n_micro, base_lr=1e-2)
    rpipe = RefPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=0)
    for i in range(3):
        rb, b = rpipe.next_batch(), pipe.next_batch()
        for k in rb:
            np.testing.assert_array_equal(b[k], rb[k])
        params, ropt, rl = rstep(params, ropt,
                                 {k: jnp.asarray(v) for k, v in rb.items()})
        model, opt, tl = step(model, opt, to_device(b, "cpu"))
        np.testing.assert_allclose(float(tl), float(rl), rtol=1e-5)
    got = convert.lm_params_to_numpy(cfg, model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert int(opt.step) == int(ropt.step) == 3


def test_first_step_leaves_parameters_bit_equal():
    """lr is 0 at step 0: the first step changes no parameter bit."""
    cfg, _, _, model = setup("qwen2-1.5b", dtype=jnp.bfloat16)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=0)
    make_train_step(cfg)(model, adamw_init(model),
                         to_device(pipe.next_batch(), "cpu"))
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n


@pytest.mark.parametrize("shape,dtype", [((1000,), "float32"),
                                         ((256,), "float32"),
                                         ((7, 300), "bfloat16"),
                                         ((3,), "float32")])
def test_int8_compression_byte_equal(shape, dtype):
    rng = np.random.default_rng(0)
    g = rng.normal(0, 0.02, shape).astype(np.float32)
    g.reshape(-1)[0] = 0.0
    jg = jnp.asarray(g, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    rq, rs = ref_gc.compress_int8(jg)
    q, s = compress_int8(tg)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    back = decompress_int8(q, s, shape)
    rback = ref_gc.decompress_int8(rq, rs, shape)
    assert back.numpy().tobytes() == np.asarray(rback).tobytes()
    err = float((back - tg.float()).abs().max())
    assert err <= float(tg.float().abs().max()) / 127 + 1e-7


def test_compression_ratio_equal():
    for shape in ((1 << 20,), (1000,), (3, 5), (256,)):
        for nbytes in (2, 4):
            assert compression_ratio(shape, nbytes) == \
                ref_gc.compression_ratio(shape, nbytes)
    assert compression_ratio((1 << 20,)) > 3.5


# ------------------------------------------- compressed mean over 4 ranks --
N_RANKS = 4
PSUM_SHAPES = {"a": ((300,), "float32"), "b": ((4, 70), "bfloat16")}

_REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.grad_compress import compressed_psum_cb

inp = dict(np.load(sys.argv[1]))
shapes = json.loads(sys.argv[2])
mesh = Mesh(np.array(jax.devices()[:4]), ("data",))
g = {k: jnp.asarray(inp[f"g_{k}"], jnp.dtype(dt)) for k, (_, dt) in
     shapes.items()}
r = {k: jnp.asarray(inp[f"r_{k}"]) for k in shapes}
fn = jax.jit(shard_map(lambda g, r: compressed_psum_cb(g, r, "data"),
                       mesh=mesh, in_specs=(P("data"), P("data")),
                       out_specs=(P("data"), P("data"))))
out = {}
for step in range(2):
    mean, r = fn(g, r)
    for k in shapes:
        out[f"s{step}_mean_{k}"] = np.asarray(mean[k], np.float32)
        out[f"s{step}_res_{k}"] = np.asarray(r[k])
np.savez(sys.argv[3], **out)
print("ok")
"""

_PORT_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from repro_torch.launch.mesh import make_shard_mesh, spawn_ranks
from repro_torch.optim import compressed_psum_cb


def rank_main(rank, n, inputs, shapes):
    inp = dict(np.load(inputs))
    mesh = make_shard_mesh(n, device="cpu")
    g = {k: torch.from_numpy(inp[f"g_{k}"][rank:rank + 1]).to(
        getattr(torch, dt)) for k, (_, dt) in shapes.items()}
    r = {k: torch.from_numpy(inp[f"r_{k}"][rank:rank + 1]) for k in shapes}
    out = {}
    for step in range(2):
        mean, r = compressed_psum_cb(g, r, mesh)
        for k in shapes:
            assert mean[k].dtype == g[k].dtype
            out[f"s{step}_mean_{k}"] = mean[k].float().numpy()
            out[f"s{step}_res_{k}"] = r[k].numpy()
    return out


if __name__ == "__main__":
    inputs, shapes, dest = sys.argv[1:4]
    per_rank = spawn_ranks(rank_main, 4, inputs, json.loads(shapes),
                           timeout=300)
    np.savez(dest, **{k: np.concatenate([r[k] for r in per_rank])
                      for k in per_rank[0]})
    print("ok")
"""


def _run(args, env_extra, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    out = subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.slow
def test_compressed_psum_cb_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    arrs = {}
    for k, (shape, _) in PSUM_SHAPES.items():
        arrs[f"g_{k}"] = rng.normal(0, 0.02, (N_RANKS,) + shape).astype(
            np.float32)
        arrs[f"r_{k}"] = rng.normal(0, 1e-4, (N_RANKS,) + shape).astype(
            np.float32)
    inputs = tmp_path / "inputs.npz"
    np.savez(inputs, **arrs)
    shapes = json.dumps(PSUM_SHAPES)
    _run(["-c", _REF_SCRIPT, str(inputs), shapes, str(tmp_path / "ref.npz")],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
          "JAX_PLATFORMS": "cpu"}, tmp_path)
    script = tmp_path / "port_ranks.py"
    script.write_text(_PORT_SCRIPT)
    _run([str(script), str(inputs), shapes, str(tmp_path / "port.npz")], {},
         tmp_path)
    ref, port = dict(np.load(tmp_path / "ref.npz")), \
        dict(np.load(tmp_path / "port.npz"))
    assert set(ref) == set(port)
    for k in ref:
        assert port[k].shape == ref[k].shape, k
        leaf = k.rsplit("_", 1)[1]
        if k.startswith("s0_mean"):
            assert port[k].tobytes() == ref[k].tobytes(), k
        else:
            lim = 2.0 ** -21 * float(np.abs(ref[f"s0_mean_{leaf}"]).max())
            assert float(np.abs(port[k] - ref[k]).max()) <= lim, k
    # Every rank holds the same mean; it is close to the exact one.
    for k, (shape, _) in PSUM_SHAPES.items():
        m = port[f"s0_mean_{k}"]
        assert (m == m[:1]).all()
        exact = arrs[f"g_{k}"].mean(0) + arrs[f"r_{k}"].mean(0)
        assert np.abs(m[0] - exact).max() < 2e-3
