"""LR schedules (the port of ``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, min_frac: float = 0.1
                    ) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup`` steps, then a cosine
    down to ``min_frac * base_lr`` at ``total``; float32, on ``step``'s
    device (0 at step 0).  The divisions are by float32 tensors: on a CUDA
    tensor a division by a Python scalar is a product by its reciprocal."""
    step = torch.as_tensor(step).to(torch.float32)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=step.device)

    warm = base_lr * torch.clamp(step / f32(max(warmup, 1)), max=1.0)
    prog = torch.clamp((step - warmup) / f32(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, base_lr * cos)
