"""End-to-end LM training with fault injection and restart (the port of
``examples/train_lm.py``).

Trains a reduced qwen2-1.5b for 40 steps, kills it twice mid-run, and
shows the loss trajectory is identical to an uninterrupted run (the
checkpoint + deterministic-pipeline guarantee).  The weights are bfloat16,
as the reference's ``init_params`` makes them, so every restart restores
bfloat16 leaves (the reference's ``restore`` cannot: ROADMAP, its fault 9).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
"""
import argparse
import shutil
import tempfile

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.core.types import resolve_device
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.train import make_train_step, to_device
from repro_torch.models import Model
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.fault import FailureInjector, FaultTolerantLoop

cfg = reduced_config("qwen2-1.5b")
STEPS, BATCH, SEQ = 40, 4, 64


def run(fail_at, ckpt_dir, device):
    model = Model(cfg, device=device, seed=0)
    opt = adamw_init(model)
    step_fn = make_train_step(cfg)
    pipeline = TokenPipeline(vocab=cfg.vocab, seq_len=SEQ,
                             global_batch=BATCH, seed=0)

    def loop_step(state, batch):
        m, o = state
        m, o, loss = step_fn(m, o, to_device(batch, device))
        return (m, o), float(loss)

    loop = FaultTolerantLoop(
        step_fn=loop_step, init_state=(model, opt), pipeline=pipeline,
        ckpt=CheckpointManager(ckpt_dir), ckpt_every=10,
        injector=FailureInjector(fail_at))
    loop.run(STEPS)
    return loop


def main(argv=None) -> float:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    d1, d2 = tempfile.mkdtemp(), tempfile.mkdtemp()
    try:
        clean = run((), d1, dev)
        faulty = run((17, 23), d2, dev)
        print(f"clean   loss: {clean.metrics[0]:.3f} -> "
              f"{clean.metrics[STEPS-1]:.3f}")
        print(f"faulty  loss: {faulty.metrics[0]:.3f} -> "
              f"{faulty.metrics[STEPS-1]:.3f} (restarts={faulty.restarts})")
        drift = max(abs(clean.metrics[s] - faulty.metrics[s])
                    for s in range(30, STEPS))
        print(f"post-recovery trajectory drift: {drift:.2e} (exact replay)")
    finally:
        shutil.rmtree(d1, ignore_errors=True)
        shutil.rmtree(d2, ignore_errors=True)
    return drift


if __name__ == "__main__":
    main()
