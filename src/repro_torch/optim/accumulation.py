"""Gradient accumulation over micro-batches (the port of
``repro.optim.accumulation``).

Keeps peak activation memory at one micro-batch while preserving the
global batch.  The reference scans over the micro-batches; the port loops.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..models import partition


def accumulate_grads(loss_fn: Callable, model, batch: Dict[str, torch.Tensor],
                     n_micro: int) -> Tuple[torch.Tensor, Dict[str,
                                                               torch.Tensor]]:
    """``loss_fn(model, batch)``'s value and its gradients by parameter
    name, over ``n_micro`` equal slices of the batch's leading dim.  With
    ``n_micro > 1`` the loss and gradients are summed in float32 and scaled
    by ``1 / n_micro``; with one, the gradients keep the parameters' dtype.
    A parameter no path reads gets zeros, as ``jax.grad`` gives it."""
    params = dict(model.named_parameters())

    def value_and_grad(mb):
        loss = loss_fn(model, mb)
        gs = torch.autograd.grad(loss, list(params.values()),
                                 allow_unused=True)
        return loss.detach(), dict(zip(params, gs))

    if n_micro <= 1:
        loss, grads = value_and_grad(batch)
        return loss, {k: torch.zeros_like(params[k]) if g is None else g
                      for k, g in grads.items()}

    if partition.current_mesh() is None:
        micro = {k: v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
                 for k, v in batch.items()}
    else:
        # On a dry run's mesh the batch dim is split over the data axes:
        # micro-batch i takes rows i, i + n_micro, ..., so that each
        # device's rows split evenly (the same global batch).
        micro = {k: v.reshape((v.shape[0] // n_micro, n_micro) + v.shape[1:])
                 .transpose(0, 1) for k, v in batch.items()}
    tot_l = None
    # zeros_like: on a dry run's mesh a DTensor parameter's accumulator is
    # laid out as the parameter is.
    tot_g = {k: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for k, p in params.items()}
    for i in range(n_micro):
        loss, grads = value_and_grad({k: v[i] for k, v in micro.items()})
        tot_l = loss.float() if tot_l is None else tot_l + loss
        for k, g in grads.items():
            if g is not None:
                tot_g[k] += g
        del grads
    scale = 1.0 / n_micro
    return tot_l * scale, {k: g.mul_(scale) for k, g in tot_g.items()}
