"""AdamW, written out by hand (the port of ``repro.optim.adamw``).

Not ``torch.optim.AdamW``: its bias correction and decoupled decay round
differently.  The moments are float32 whatever the parameters' dtype, and
there is no float32 master copy: a bfloat16 parameter takes
``p - (lr * delta)`` rounded to bfloat16.  Weight decay applies to every
parameter, norms and biases included.  A parameter with no gradient
(``None``, which autograd gives a parameter no path reads, where the
reference's tree has a zero leaf) takes a zero gradient: its moments
decay and the parameter decays.

The parameters are a ``Model`` (any ``nn.Module``) or a dict of tensors by
name; the gradients and moments are dicts by the same names.  The update
writes the parameters and the moments in place and returns them.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch import nn


class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32 scalar
    m: Dict[str, torch.Tensor]         # float32, by parameter name
    v: Dict[str, torch.Tensor]


def _named_params(params) -> Dict[str, torch.Tensor]:
    """A module's parameters, or a dict of tensors, by name."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params) -> AdamWState:
    named = _named_params(params)
    dev = next(iter(named.values())).device
    # zeros_like: a DTensor parameter's moments are laid out as it is.
    zeros = {k: torch.zeros_like(p, dtype=torch.float32,
                                 memory_format=torch.contiguous_format)
             for k, p in named.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[object, AdamWState]:
    """One step at learning rate ``lr`` (a float or a float32 scalar
    tensor).  Each Python scalar enters a float32 product rounded to
    float32, as a weakly typed scalar does in JAX; divisions are by
    float32 tensors (a division by a Python scalar on a CUDA tensor is a
    product by its reciprocal, which rounds differently)."""
    named = _named_params(params)
    step = state.step + 1
    dev = step.device
    stepf = step.to(torch.float32)
    b1t = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev),
                          stepf)
    b2t = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev),
                          stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    for name, p in named.items():
        m, v = state.m[name], state.v[name]
        g = grads.get(name)
        gf = (torch.zeros_like(m) if g is None
              else g.to(torch.float32))
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_(gf.square().mul_(1 - b2))
        delta = (m / b1t) / ((v / b2t).sqrt_().add_(eps))
        delta.add_(p.to(torch.float32) * weight_decay)
        p.sub_((delta.mul_(lr)).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)
