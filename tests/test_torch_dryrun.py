"""The port's dry run (``repro_torch.launch.dryrun``) on fake tensors, one
reduced configuration of each family (dense, MLA + MoE, dense-residual
MoE, SSM hybrid, encoder-decoder, vision prefix) x train/prefill/decode:

* ``card`` (one card, no mesh): the trace's peak lies within
  ``dryrun.PEAK_TOL`` of the real CPU step's, run with no dispatch mode
  and measured from the profiler's allocation events, and its FLOPs equal
  ``FlopCounterMode`` over another real step.
* On a (data 2, model 4) mesh over the fake process group, in one fresh
  interpreter (a process holds one default group): every cell ends
  ``ok``, its per-device parameter bytes equal the sum of the local
  shards, and the points where the model runs on local tensors are
  recorded.
* The graph dry run's collective and staged bytes equal the ``ShardMesh``
  exchanges reckoned by hand.
"""
import pytest

torch = pytest.importorskip("torch")

from _dryrun_cells import (FAMILIES, SHAPES, card_check,  # noqa: E402
                           check_mesh_records, run_cells_in_subprocess)


@pytest.fixture(scope="module")
def mesh_records():
    return run_cells_in_subprocess(FAMILIES, graph=True)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", FAMILIES)
def test_card_trace_equals_a_real_step(arch, shape):
    card_check(arch, shape)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_cells(arch, mesh_records):
    check_mesh_records(mesh_records, [arch])


def test_graph_dry_run_bytes(mesh_records):
    # The graph dry run at 2^8 vertices and 2^10 edges a shard on 16
    # shards, 3 sweeps, a router batch of 2^8 slots in buckets of 2^5.
    g = mesh_records[("lsmgraph-service", "V4096_E16384")]
    assert g["status"] == "ok" and g["chips"] == 256
    vl, n, iters = 1 << 8, 16, 3
    # Each sweep gathers the float32 contributions and all-reduces the
    # dangling mass; one more gather returns the iterate.
    assert g["coll_breakdown"] == {"all-gather": (iters + 1) * vl * 4,
                                   "all-reduce": iters * 4}
    staged = (iters + 1) * (vl * 4 + n * vl * 4) + iters * (4 + 4)
    assert g["staged_bytes_per_device"] == staged
    # The router's one all-to-all of src, dst and prop: 3 x 16 x 32 int32.
    assert g["router_coll_breakdown"] == {"all-to-all": 3 * n * 32 * 4}
    assert g["router_staged_bytes"] == 2 * 3 * n * 32 * 4


def test_pick_last_is_gather_with_its_backward_in_place():
    """``model.pick_last`` (the loss's target logit) equals
    ``torch.gather`` forward and backward, bit for bit, and its backward
    adds into zeros in place under a dispatch mode too, where torch's own
    gather backward takes an out-of-place ``scatter_add``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.model import pick_last

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.add(str(func))
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 40, generator=g, requires_grad=True)
    idx = torch.randint(0, 40, (3, 5), generator=g, dtype=torch.int32)
    w = torch.randn(3, 5, generator=g)
    want = torch.gather(x, -1, idx.long()[..., None])[..., 0]
    gw, = torch.autograd.grad((want * w).sum(), x)
    got = pick_last(x, idx)
    seen = Seen()
    with seen:
        gg, = torch.autograd.grad((got * w).sum(), x)
    assert torch.equal(got, want) and torch.equal(gg, gw)
    assert "aten.scatter_add_.default" in seen.ops
    assert "aten.scatter_add.default" not in seen.ops


def test_step_peak_is_the_same_under_a_dispatch_mode():
    """A training step whose peak is set by the loss's float32 logits
    (a 32,768-word vocab) holds no more bytes under a dispatch mode that
    only calls each op than with none, so a trace (which runs under such
    modes) sees the plain step's peak."""
    import dataclasses
    from torch.utils._python_dispatch import TorchDispatchMode
    from _dryrun_cells import plain_peak
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import Model
    from repro_torch.optim import adamw_init

    class Through(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"), vocab=32768)
    model = Model(cfg, device="cpu", seed=0)
    opt = adamw_init(model)
    batch = dryrun.input_specs(cfg, ShapeConfig("t", 64, 4, "train"), "cpu")
    step = dryrun.make_train_step(cfg, n_micro=2)
    logits = 2 * 64 * cfg.vocab * 4
    plain = plain_peak(lambda: step(model, opt, batch))
    assert plain > 3 * logits    # the loss's tensors set the peak

    def under_mode():
        with Through():
            step(model, opt, batch)
    assert plain_peak(under_mode) == plain
