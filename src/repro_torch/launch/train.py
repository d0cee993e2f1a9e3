"""End-to-end training entry point (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --reduced --steps 50 --batch 8 --seq 128 [--ckpt-dir DIR] \
        [--device cpu]

Wires: config -> random weights (bfloat16, from a generator on the device
seeded by ``--seed``) -> train step (micro-batched loss and gradients,
cosine schedule, AdamW) -> deterministic pipeline -> fault-tolerant loop
with atomic checkpoints.  It prints the reference's three lines
(``arch=...``, ``done: ...``, ``timing: ...``).  The run lives on
``--device`` (default: the current CUDA card; it fails when there is none,
unless ``--device cpu`` is given).  The step is eager; the reference's
``jax.jit`` with donated buffers becomes updates in place.  The
reference's FSDP x TP shardings (``launch/shardings.py``,
``NamedSharding``) have no counterpart on one card.  Without
``--ckpt-dir`` the checkpoints go to a fresh temporary directory, removed
at the end (the reference's default is a fixed ``/tmp/repro_ckpt``).
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs import get_config, reduced_config
from ..core.types import resolve_device
from ..data.pipeline import TokenPipeline
from ..models import model as modellib
from ..optim.accumulation import accumulate_grads
from ..optim.adamw import AdamWState, adamw_init, adamw_update
from ..optim.schedule import cosine_schedule
from ..runtime.fault import FailureInjector, FaultTolerantLoop
from ..runtime.monitor import StepMonitor


def make_train_step(cfg, *, n_micro: int = 1, base_lr: float = 3e-4):
    """-> ``step(model, opt, batch) -> (model, opt, loss)``: the loss and
    gradients over ``n_micro`` micro-batches, the learning rate of
    ``opt.step`` (0 at step 0), one AdamW update of ``model`` and ``opt``
    in place."""
    def loss_fn(model, batch):
        return modellib.loss(cfg, model, batch)

    def step(model, opt: AdamWState, batch):
        loss, grads = accumulate_grads(loss_fn, model, batch, n_micro)
        lr = cosine_schedule(opt.step, base_lr=base_lr)
        model, opt = adamw_update(model, grads, opt, lr=lr)
        return model, opt, loss

    return step


def to_device(batch, device) -> dict:
    """A pipeline batch (NumPy) as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def main(argv=None) -> FaultTolerantLoop:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"active={cfg.active_param_count()/1e6:.1f}M")

    model = modellib.Model(cfg, device=dev, seed=args.seed)
    opt = adamw_init(model)
    step_fn = make_train_step(cfg, n_micro=args.micro)
    pipeline = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch, seed=args.seed)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-ckpt-")
    mon = StepMonitor()

    def loop_step(state, batch):
        model, opt = state
        mon.start()
        model, opt, loss = step_fn(model, opt, to_device(batch, dev))
        loss = float(loss)
        mon.stop()
        return (model, opt), loss

    try:
        loop = FaultTolerantLoop(
            step_fn=loop_step, init_state=(model, opt), pipeline=pipeline,
            ckpt=CheckpointManager(ckpt_dir), ckpt_every=args.ckpt_every,
            injector=FailureInjector(args.fail_at))
        t0 = time.time()
        loop.run(args.steps)
        dt = time.time() - t0
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [loop.metrics[s] for s in sorted(loop.metrics)]
    print(f"done: {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"restarts={loop.restarts} stragglers={loop.stragglers}")
    print("timing:", mon.summary())
    return loop


if __name__ == "__main__":
    main()
