"""The port's sharding policy against the JAX package's.

* For all ten architectures at full width, the port's parameter, cache and
  batch specs (``repro_torch.launch.shardings``) equal the reference's
  ``param_pspecs`` / ``cache_pspecs`` / ``batch_pspecs`` on a
  ``jax.sharding.AbstractMesh`` (no devices) of both production shapes,
  (data 16, model 16) and (pod 2, data 16, model 16).  The reference stacks
  a period's layers on a leading axis that no rule splits; the port's
  layers stand apart, so each stacked leaf's spec is compared without its
  leading entry.
* The port's ``Model`` builds at full width under ``FakeTensorMode``.
* ``partition.resolve`` (what ``constrain`` redistributes to) and
  ``constrain_scores``' choice against hand cases, Qwen2-1.5B's 12 heads on
  a 16-way model axis among them.

No process group is started here: the specs need only a mesh's axis names
and sizes.
"""
from typing import NamedTuple, Tuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import shardings as ref_sh  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import shardings  # noqa: E402
from repro_torch.models import Model, init_cache  # noqa: E402
from repro_torch.models import partition  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


class AxisMesh(NamedTuple):
    """Axis names and sizes: all the specs read of a mesh."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]


def _spec(p) -> tuple:
    return tuple(p) if p is not None else ()


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_sh._path_str(path): leaf for path, leaf in flat}


def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


@pytest.fixture(scope="module")
def fake_models():
    """Each architecture's port ``Model`` at full width, fake weights."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {}
    with FakeTensorMode():
        for arch in ARCH_IDS:
            out[arch] = Model(get_config(arch), device="cpu", seed=0)
    return out


def test_fake_models_build_at_full_width(fake_models):
    """Each fake model holds as many weights as the reference's
    ``param_shapes`` of the same config, and none of them is real."""
    from torch._subclasses.fake_tensor import FakeTensor
    for arch, model in fake_models.items():
        want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
            ref_model.param_shapes(ref_get_config(arch))))
        assert sum(p.numel() for p in model.parameters()) == want, arch
        assert all(isinstance(p, FakeTensor) for p in model.parameters())


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference(arch, mesh_name, fake_models):
    shape, axes = MESHES[mesh_name]
    ref_mesh = AbstractMesh(shape, axes)
    cfg_ref = ref_get_config(arch)
    params_abs = ref_model.param_shapes(cfg_ref)
    ref = _flat_ref(jax.tree.map(
        lambda x: x, ref_sh.param_pspecs(cfg_ref, ref_mesh, params_abs),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    shapes = _flat_ref(params_abs)
    # Which reference leaf each port parameter holds: the unstacking that
    # carries the weights over, applied to leaf ids.
    paths = sorted(shapes)
    ids = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params_abs),
        [np.full((shapes[p].shape[0],), paths.index(p)) for p in
         [ref_sh._path_str(q) for q, _ in
          jax.tree_util.tree_flatten_with_path(params_abs)[0]]])
    of = {name: paths[int(np.ravel(v)[0])]
          for name, v in convert._unstack(cfg_ref, ids).items()}
    got = shardings.param_specs(get_config(arch), AxisMesh(shape, axes),
                                fake_models[arch])
    assert set(got) == set(of), arch
    for name, spec in got.items():
        path = of[name]
        ref_full = _pad(_spec(ref[path]), len(shapes[path].shape))
        n = len(spec)
        if len(ref_full) == n + 1:      # a stacked leaf
            assert ref_full[0] is None, (arch, name, ref_full)
            ref_full = ref_full[1:]
        assert spec == ref_full, (arch, mesh_name, name, spec, ref_full)


def _ref_cache_specs(cfg, mesh, b, s, enc_len):
    cache_abs = jax.eval_shape(lambda: ref_model.init_cache(
        cfg, b, s, enc_len=enc_len))
    specs = ref_sh.cache_pspecs(cfg, mesh, cache_abs)
    return _flat_ref(cache_abs), _flat_ref(
        jax.tree.map(lambda x: x, specs,
                     is_leaf=lambda x: isinstance(
                         x, jax.sharding.PartitionSpec)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch, mesh_name):
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape, axes = MESHES[mesh_name]
    ref_mesh = AbstractMesh(shape, axes)
    mesh = AxisMesh(shape, axes)
    cfg_ref, cfg = ref_get_config(arch), get_config(arch)
    b, s = 128, 32768
    enc_len = 16384 if cfg.family == "encdec" else 0
    ref_abs, ref_specs = _ref_cache_specs(cfg_ref, ref_mesh, b, s, enc_len)
    with FakeTensorMode():
        cache = init_cache(cfg, b, s, device="cpu")
    prefix, period, _ = ref_model.plan_layers(cfg_ref)
    for i, layer in enumerate(cache["layers"]):
        for key, t in layer.items():
            if i < len(prefix):
                path, lead = f"prefix/{i}/{key}", 0
            else:
                path = f"period/{(i - len(prefix)) % len(period)}/{key}"
                lead = 1
            want = _pad(ref_specs[path], len(ref_abs[path].shape))[lead:]
            assert tuple(ref_abs[path].shape)[lead:] == tuple(t.shape)
            got = shardings.cache_spec(mesh, key, t.shape)
            assert got == want, (arch, mesh_name, path, got, want)
    if enc_len:
        for key in ("k", "v"):
            path = f"cross/{key}"
            want = _pad(ref_specs[path], len(ref_abs[path].shape))[1:]
            got = shardings.cache_spec(mesh, key, ref_abs[path].shape[1:])
            assert got == want, (arch, path, got, want)
    # The batch: train tokens/targets/frontend and a decode token.
    for leaf_shape in ((256, 4096), (256, 256, cfg.d_model), (128,), (1,)):
        leaf = jax.ShapeDtypeStruct(leaf_shape, jnp.int32)
        want = _pad(_spec(ref_sh.batch_pspecs(cfg_ref, ref_mesh, leaf)),
                    len(leaf_shape))
        assert shardings.batch_spec(mesh, leaf_shape) == want


def test_qwen2_small_mesh_spec_count():
    """Qwen2-1.5B on (2, 4): the reference's 14 leaves of the stacked tree
    are the port's 28-layer unstacked names, every one with a spec."""
    cfg_ref = ref_get_config("qwen2-1.5b")
    ref = ref_sh.param_pspecs(cfg_ref, AbstractMesh((2, 4),
                                                    ("data", "model")),
                              ref_model.param_shapes(cfg_ref))
    assert len(jax.tree.leaves(ref, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))) == 14


@pytest.mark.parametrize("shape,spec,mesh,want", [
    # dp resolves to the bundle on the multi-pod mesh.
    ((64, 4096, 1536), ("dp", "model", None), "multipod",
     (("pod", "data"), "model", None)),
    ((64, 4096, 1536), ("dp", "model", None), "single",
     ("data", "model", None)),
    # An axis that does not divide its dim is dropped.
    ((8, 4096, 1536), ("dp", "model", None), "single",
     (None, "model", None)),
    ((16, 100, 7), ("dp", "model", None), "single", ("data", None, None)),
    # A spec shorter than the tensor pads with None.
    ((32, 12, 4096, 4096), ("dp",), "single", ("data", None, None, None)),
])
def test_resolve_hand_cases(shape, spec, mesh, want):
    m = AxisMesh(*MESHES[mesh])
    assert partition.resolve(m, shape, spec) == want


def test_resolve_drops_a_missing_model_axis():
    m = AxisMesh((4,), ("data",))
    assert partition.resolve(m, (8, 16), ("dp", "model")) == ("data", None)


@pytest.mark.parametrize("heads,want", [
    (12, ("data", None, None, "model")),   # Qwen2-1.5B: keys over model
    (16, ("data", "model", None, None)),
    (128, ("data", "model", None, None)),  # DeepSeek-V2's MLA heads
    (28, ("data", None, None, "model")),   # Qwen2-7B
])
def test_constrain_scores_path(heads, want, monkeypatch):
    """``constrain_scores`` takes the heads over ``model`` when 16 divides
    them, else the key dim; the spec it asks for, resolved."""
    m = AxisMesh(*MESHES["single"])
    asked = []
    monkeypatch.setattr(partition, "current_mesh", lambda: m)
    monkeypatch.setattr(partition, "constrain",
                        lambda x, *spec: asked.append(
                            partition.resolve(m, x.shape, spec)))
    partition.constrain_scores(torch.empty((32, heads, 64, 4096),
                                           device="meta"))
    assert asked == [want]


def test_placements_of_a_bundle():
    from torch.distributed.tensor import Replicate, Shard
    m = AxisMesh(*MESHES["multipod"])
    assert partition.placements(m, (("pod", "data"), "model", None)) == [
        Shard(0), Shard(0), Shard(1)]
    assert partition.placements(m, (None, None)) == [Replicate()] * 3


def test_outside_a_mesh_every_call_is_identity():
    x = torch.randn(2, 4, 8)
    assert partition.current_mesh() is None
    assert partition.constrain(x, "dp", "model", None) is x
    assert partition.constrain_scores(x[None]) is not None
    for fn in (partition.gather_seq, partition.settle, partition.whole_last):
        assert fn(x) is x
    assert partition.split_last(x, 2, 4).shape == (2, 4, 2, 4)
    assert partition.local("p", lambda a: a + 1, [x], [None], [None]) \
        .equal(x + 1)
    assert partition.replicated_at() == []
