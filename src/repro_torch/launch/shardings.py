"""Sharding policy: FSDP (ZeRO-3) over (pod, data) x tensor/expert
parallelism over ``model``, for every assigned architecture (the port of
``repro.launch.shardings``).

The rules are the reference's, keyed on its parameter-tree paths: a port
parameter name (``blocks.5.attn.wq.w``) is first written as the reference
path of the same leaf (``period/0/attn/wq/w``; ``convert._unstack`` maps the
two sets of names).  Every rule degrades to replication when a dim does not
divide by its mesh axis (the odd 92,553 InternVL vocab keeps its vocab dim
replicated but splits d_model).  The reference stacks the layers of a
period on a leading axis, which no rule splits; the port holds each layer
apart, so that axis is gone and the spec is the reference's without it.

Activation and cache policy: the batch over the data-parallel bundle when
it divides; every k/v or latent cache's sequence over ``model``; SSM state
heads over ``model`` (``models.partition.CACHE_SPECS``).

A spec is a tuple with one entry a tensor dim: a mesh axis name, a tuple of
names (the data-parallel bundle), or ``None``; ``partition.placements``
turns one into DTensor placements.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..models import partition
from ..models.model import plan_layers

_pl = partition.placements


def ref_path(cfg: ModelConfig, name: str) -> str:
    """The reference's tree path of the leaf that port parameter ``name``
    holds (one layer of it, for a stacked leaf)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        n_prefix = len(plan_layers(cfg)[0])
        i = int(parts[1])
        if i < n_prefix:
            head = ["prefix", str(i)]
        else:
            head = ["period", str((i - n_prefix) % len(plan_layers(cfg)[1]))]
        return "/".join(head + parts[2:])
    if parts[0] in ("enc", "cross"):
        return "/".join([parts[0]] + parts[2:])
    return "/".join(parts)


def _mlp_rule(pathstr: str, dp):
    if pathstr.endswith("wd/w"):
        return ("model", dp)
    if pathstr.endswith("/b"):
        return ("model",)
    return (dp, "model")


def param_rule(pathstr: str, ndim: int, dp) -> Tuple:
    """The reference's rule for one leaf path, for a leaf of ``ndim``
    dims, before the divisibility guard."""
    base = None
    if pathstr.endswith("embed"):
        base = ("model", dp)
    elif pathstr.endswith("head"):
        base = (dp, "model")
    elif "/moe/" in pathstr or pathstr.endswith("router/w"):
        if pathstr.endswith("router/w"):
            base = (dp, None)
        elif pathstr.endswith("wg") or pathstr.endswith("wu"):
            base = ("model", dp, None)      # (E, d, ff): EP over model
        elif pathstr.endswith("wd"):
            base = ("model", None, dp)
        elif "/shared/" in pathstr or "/dense/" in pathstr:
            base = _mlp_rule(pathstr, dp)
    elif "/mlp/" in pathstr:
        base = _mlp_rule(pathstr, dp)
    elif "/ssm/" in pathstr:
        if "in_proj" in pathstr:
            base = (dp, "model")
        elif "out_proj" in pathstr:
            base = ("model", dp)
        elif "conv_w" in pathstr:
            base = (None, "model")
        else:           # conv_b, norm_scale, A_log, D, dt_bias
            base = ("model",)
    elif "/attn/" in pathstr or "/cross/" in pathstr:
        if pathstr.endswith("wo/w"):
            base = ("model", dp)
        elif pathstr.endswith("/b"):
            base = ("model",)
        elif "norm" in pathstr:
            base = (None,)
        else:           # wq/wk/wv/wdq/wuq/wdkv/...
            base = (dp, "model")
    if base is None:
        base = (None,) * ndim
    if len(base) < ndim:
        base = (None,) * (ndim - len(base)) + tuple(base)
    return tuple(base[:ndim])


def param_specs(cfg: ModelConfig, mesh, model: nn.Module
                ) -> Dict[str, Tuple]:
    """Each parameter's spec, by name: the rule, then every axis that does
    not divide its dim dropped (``partition.resolve``)."""
    dp = partition._dp_bundle(mesh)
    return {name: partition.resolve(
        mesh, tuple(p.shape), param_rule(ref_path(cfg, name), p.dim(), dp))
        for name, p in model.named_parameters()}


def batch_spec(mesh, shape) -> Tuple:
    """A batch leaf (tokens, targets, frontend, a decode token) over the
    data-parallel bundle on its leading dim."""
    return partition.resolve(mesh, tuple(shape), ("dp",))


def cache_spec(mesh, name: str, shape) -> Tuple:
    """A cache leaf by its key (``k``, ``v``, ``ckv``, ``kr``, ``h``,
    ``conv``)."""
    return partition.resolve(mesh, tuple(shape), partition.cache_spec(name))


def param_placements(cfg: ModelConfig, mesh, model: nn.Module) -> Dict:
    return {n: _pl(mesh, s) for n, s in param_specs(cfg, mesh, model).items()}


def batch_placements(mesh, batch: Dict[str, torch.Tensor]) -> Dict:
    return {k: _pl(mesh, batch_spec(mesh, v.shape)) for k, v in batch.items()}


def cache_placements(mesh, cache) -> Dict:
    """``{"layers": [...], "cross": [...]}`` of placements, as the cache."""
    def of(entries):
        return [{k: _pl(mesh, cache_spec(mesh, k, v.shape))
                 for k, v in c.items()} for c in entries]
    out = {"layers": of(cache["layers"])}
    if "cross" in cache:
        out["cross"] = of(cache["cross"])
    return out


def distribute_params(cfg: ModelConfig, mesh, model: nn.Module) -> Dict:
    """Replace every parameter of ``model`` with a DTensor laid out by its
    spec; returns the specs by name."""
    from torch.distributed.tensor import distribute_tensor
    specs = param_specs(cfg, mesh, model)
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = getattr(mod, leaf)
        d = distribute_tensor(p.detach(), mesh, _pl(mesh, spec))
        mod._parameters[leaf] = nn.Parameter(d, requires_grad=p.requires_grad)
    return specs


def distribute_batch(mesh, batch: Dict[str, torch.Tensor]) -> Dict:
    from torch.distributed.tensor import distribute_tensor
    return {k: distribute_tensor(v, mesh, _pl(mesh, batch_spec(mesh, v.shape)))
            for k, v in batch.items()}


__all__ = ["ref_path", "param_rule", "param_specs", "batch_spec",
           "cache_spec", "param_placements",
           "batch_placements", "cache_placements", "distribute_params",
           "distribute_batch"]
