"""LM serving: batched prefill + greedy decode loop.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        [--reduced] --batch 4 --prompt-len 32 --gen 16 [--seed 0] \
        [--device cpu]

The port of ``repro.launch.serve``: random bfloat16 weights from ``--seed``
(a generator on the device), a random prompt from NumPy's generator seeded
the same way, then prefill and ``--gen`` greedy decode steps, eager, under
``torch.inference_mode``.  It prints the reference's two lines and the
device.  The weights and the run live on ``--device`` (default: the current
CUDA card; the run fails when there is none, unless ``--device cpu`` is
given).  On the card each timed part ends in ``torch.cuda.synchronize``.

One departure from the reference: a vision frontend's prefix takes the
cache's first positions, so the first decoded token sits after prefix and
prompt (the reference decodes at ``prompt_len + i`` and overwrites the last
prompt positions; ROADMAP, the reference's fault 8).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..configs.base import ModelConfig
from ..core.types import resolve_device
from ..models import model as modellib

FRONTEND_LEN = {"vision": 8, "audio": 32}   # the reference's stub lengths


def make_batch(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """The reference's request: tokens uniform in [1, vocab), then for a
    frontend stub embeddings ~ N(0, 1) in bfloat16, from one NumPy
    generator seeded by ``seed``."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(1, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    ).to(device)}
    if cfg.frontend in FRONTEND_LEN:
        out["frontend"] = torch.from_numpy(rng.normal(
            0, 1, (batch, FRONTEND_LEN[cfg.frontend], cfg.d_model)).astype(
                np.float32)).to(device=device, dtype=torch.bfloat16)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> int:
    """Positions the prompt fills in the cache: its tokens, after a
    vision prefix (an encdec frontend feeds the encoder instead)."""
    n = batch["tokens"].shape[1]
    if "frontend" in batch and cfg.family != "encdec":
        n += batch["frontend"].shape[1]
    return n


@torch.inference_mode()
def serve(cfg: ModelConfig, model: modellib.Model,
          batch: Dict[str, torch.Tensor], gen: int,
          s_max: Optional[int] = None) -> dict:
    """Prefill ``batch`` and decode ``gen`` tokens greedily.  Returns the
    generated tokens [B, gen] (the prefill's argmax first), the prefill's
    last logits, the cache, and the host-clock seconds of the prefill and
    of the decode loop (each ending in a synchronise on the card)."""
    dev = batch["tokens"].device
    b = batch["tokens"].shape[0]
    pos0 = prompt_positions(cfg, batch)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = modellib.prefill(cfg, model, batch, s_max=s_max)
    _sync(dev)
    t_pf = time.perf_counter() - t0
    prefill_logits = logits
    out = []
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok)
        logits, cache = modellib.decode_step(cfg, model, cache, tok, pos0 + i)
        tok = torch.argmax(logits, -1)
    _sync(dev)
    t_dec = time.perf_counter() - t0
    tokens = (torch.stack(out, 1).cpu().numpy() if out
              else np.zeros((b, 0), np.int64))
    return dict(tokens=tokens, prefill_logits=prefill_logits, cache=cache,
                prefill_s=t_pf, decode_s=t_dec)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = modellib.Model(cfg, device=dev, seed=args.seed)
    batch = make_batch(cfg, args.batch, args.prompt_len, args.seed, dev)
    s_max = args.prompt_len + args.gen + 8
    res = serve(cfg, model, batch, args.gen, s_max=s_max)
    t_pf, t_dec = res["prefill_s"], res["decode_s"]
    print(f"prefill {args.batch}x{args.prompt_len} in {t_pf:.2f}s; "
          f"decoded {args.gen} tokens in {t_dec:.2f}s "
          f"({args.gen * args.batch / max(t_dec, 1e-9):.1f} tok/s)")
    print("sample:", res["tokens"][0][:16])
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"device: {dev} ({name})")
    return res


if __name__ == "__main__":
    main()
