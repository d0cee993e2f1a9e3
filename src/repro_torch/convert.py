"""State carried between the JAX package and the port, as numpy arrays.

The port's NamedTuples have the reference's fields, dtypes and padding, so
a conversion is field by field: ``*_to_torch`` takes anything whose fields
``np.asarray`` can read (jax arrays, numpy arrays) and returns the port's
tensors on ``device``; ``to_numpy`` goes back.  Presence words are uint32
in the reference and int32 bit patterns in the port.  An LM's weights,
gradients, AdamW state and decode cache cross by name
(``lm_params_to_torch``, ``lm_params_to_numpy``, ``adamw_state_to_torch``,
``lm_cache_to_torch``, ``lm_cache_to_numpy``).  Nothing here imports the
JAX package: the caller hands over arrays.
"""
from __future__ import annotations

from typing import NamedTuple, Type

import numpy as np
import torch

from .analytics.view import CSRView, RunView
from .core.index import IndexState
from .core.types import CSRRunArrays, EdgeBatch, MemGraphState
from .models.model import plan_layers
from .optim.adamw import AdamWState

_DTYPES = {np.dtype(np.int32): torch.int32,
           np.dtype(np.float32): torch.float32,
           np.dtype(np.bool_): torch.bool}


def array_to_torch(x, device) -> torch.Tensor:
    """One array (int32, float32, bool or bfloat16, any shape) as a tensor.
    NumPy's bfloat16 (``ml_dtypes``'s, which JAX's bfloat16 arrays become)
    is carried bit for bit."""
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}")
    return torch.from_numpy(a).to(device)


def _tuple_to_torch(obj, cls: Type[NamedTuple], device):
    return cls(*(array_to_torch(getattr(obj, f), device)
                 for f in cls._fields))


def to_numpy(obj):
    """A port NamedTuple (or one tensor) as numpy arrays, field by field.
    A bfloat16 tensor comes back as float32 (exactly)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return type(obj)(*(to_numpy(getattr(obj, f)) for f in obj._fields))


def csr_run_to_torch(run, device) -> CSRRunArrays:
    return _tuple_to_torch(run, CSRRunArrays, device)


def memgraph_to_torch(mg, device) -> MemGraphState:
    return _tuple_to_torch(mg, MemGraphState, device)


def index_to_torch(idx, device) -> IndexState:
    return _tuple_to_torch(idx, IndexState, device)


def edge_batch_to_torch(batch, device) -> EdgeBatch:
    return _tuple_to_torch(batch, EdgeBatch, device)


def csr_view_to_torch(view, device) -> CSRView:
    """An analytics ``CSRView`` (arrays and the two counts) as the port's."""
    return CSRView(voff=array_to_torch(view.voff, device),
                   dst=array_to_torch(view.dst, device),
                   prop=array_to_torch(view.prop, device),
                   n_vertices=int(view.n_vertices),
                   n_edges=int(view.n_edges))


def run_view_to_torch(view, device) -> RunView:
    return _tuple_to_torch(view, RunView, device)


def presence_words_to_torch(words, device) -> torch.Tensor:
    """uint32 filter words -> the port's int32 bit patterns."""
    return torch.from_numpy(
        np.asarray(words, np.uint32).view(np.int32).copy()).to(device)


def presence_words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 filter words -> the reference's uint32 words."""
    return words.cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------- LM state --
def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _block_index(cfg):
    """Model.blocks index of (period position j, period p)."""
    prefix, period, _ = plan_layers(cfg)
    return lambda j, p: len(prefix) + p * len(period) + j


def _unstack(cfg, params) -> dict:
    """The reference's parameter pytree (or one of its shape, such as an
    AdamW moment) as a flat dict by the port's parameter names."""
    block = _block_index(cfg)
    flat = {}
    for path, arr in _flatten(params):
        head, _, rest = path.partition(".")
        if head == "period":
            j, _, rest = rest.partition(".")
            for p in range(np.shape(arr)[0]):
                flat[f"blocks.{block(int(j), p)}.{rest}"] = arr[p]
        elif head in ("enc", "cross"):
            for i in range(np.shape(arr)[0]):
                flat[f"{head}.{i}.{rest}"] = arr[i]
        elif head == "prefix":
            flat[f"blocks.{rest}"] = arr
        else:
            flat[path] = arr
    return flat


def lm_params_to_torch(cfg, params, model) -> None:
    """Load the reference's parameter pytree (``init_params``'s, arrays
    NumPy can read) into ``model``, a ``repro_torch.models.Model`` of the
    same config, in place.  ``prefix.i`` is ``blocks.i``; ``period``,
    ``enc`` and ``cross`` are stacked along a leading axis in the
    reference and unstacked here.  ``[d_in, d_out]`` weights keep their
    layout.  Every parameter of either side must find its partner, with
    the same shape and dtype."""
    _load_flat(model, _unstack(cfg, params))


def lm_params_to_numpy(cfg, model, values=None) -> dict:
    """The inverse of ``lm_params_to_torch``: ``model``'s parameters, or
    ``values`` (a dict by parameter name, such as gradients; ``None`` for
    a parameter is zeros of its shape, as ``jax.grad`` gives an unused
    one), as the reference's pytree of NumPy arrays, the period layers,
    the encoder and the cross attentions restacked.  bfloat16 comes back as
    float32 (exactly)."""
    prefix, period, n_periods = plan_layers(cfg)
    named = dict(model.named_parameters())
    if values is None:
        values = named

    def leaf(name):
        v = values.get(name)
        if v is None:
            return np.zeros(tuple(named[name].shape), np.float32)
        return to_numpy(v)

    def put(tree, rest, arr):
        *dirs, last = rest.split(".")
        for d in dirs:
            tree = tree.setdefault(d, {})
        tree[last] = arr

    out = {"prefix": [{} for _ in prefix], "period": [{} for _ in period]}
    stacked = {}   # (tree, rest) -> [arrays in stack order]
    for name in named:
        head, _, rest = name.partition(".")
        if head == "blocks":
            i, _, rest = rest.partition(".")
            i = int(i)
            if i < len(prefix):
                put(out["prefix"][i], rest, leaf(name))
                continue
            j = (i - len(prefix)) % len(period)
            stacked.setdefault(("period", j, rest), []).append(leaf(name))
        elif head in ("enc", "cross"):
            _, _, rest = rest.partition(".")
            stacked.setdefault((head, None, rest), []).append(leaf(name))
        else:
            put(out, name, leaf(name))
    for (head, j, rest), arrs in stacked.items():
        tree = (out["period"][j] if head == "period"
                else out.setdefault(head, {}))
        put(tree, rest, np.stack(arrs))
    return out


def lm_tree_to_torch(cfg, tree, device) -> dict:
    """A pytree in the reference's parameter layout (gradients, a moment)
    as a dict of tensors on ``device`` by the port's parameter names."""
    return {name: array_to_torch(a, device)
            for name, a in _unstack(cfg, tree).items()}


def adamw_state_to_torch(cfg, opt, model) -> AdamWState:
    """The reference's ``AdamWState`` (``step``, and moments ``m``, ``v`` in
    its parameter pytree's layout) as the port's, on ``model``'s device."""
    dev = model.embed.device
    return AdamWState(step=torch.tensor(int(np.asarray(opt.step)),
                                        dtype=torch.int32, device=dev),
                      m=lm_tree_to_torch(cfg, opt.m, dev),
                      v=lm_tree_to_torch(cfg, opt.v, dev))


def lm_module_params_to_torch(params, module) -> None:
    """Load one reference parameter dict (``init_gqa``'s, ``init_moe``'s,
    ...) into the port's module of the same layer, in place, by name."""
    _load_flat(module, dict(_flatten(params)))


def _load_flat(module, flat) -> None:
    own = dict(module.named_parameters())
    if set(own) != set(flat):
        raise KeyError(f"parameters differ: only in the reference "
                       f"{sorted(set(flat) - set(own))[:5]}, only in the "
                       f"port {sorted(set(own) - set(flat))[:5]}")
    with torch.no_grad():
        for name, w in own.items():
            t = array_to_torch(flat[name], w.device)
            if t.shape != w.shape or t.dtype != w.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, port {tuple(w.shape)} "
                                 f"{w.dtype}")
            w.copy_(t)


def lm_cache_to_torch(cfg, cache, device) -> dict:
    """A reference decode cache (``init_cache``'s or ``prefill``'s layout:
    ``prefix``, ``period`` stacked over the periods, ``cross`` stacked over
    the decoder layers) as the port's: one dict a layer in plan order, and
    for encdec one {k, v} a decoder layer."""
    block = _block_index(cfg)
    layers = {}
    for i, c in enumerate(cache["prefix"]):
        layers[i] = {k: array_to_torch(v, device) for k, v in c.items()}
    for j, c in enumerate(cache["period"]):
        for p in range(np.shape(next(iter(c.values())))[0]):
            layers[block(j, p)] = {k: array_to_torch(v[p], device)
                                   for k, v in c.items()}
    out = {"layers": [layers[i] for i in range(len(layers))]}
    if "cross" in cache:
        n = np.shape(cache["cross"]["k"])[0]
        out["cross"] = [{k: array_to_torch(cache["cross"][k][i], device)
                         for k in ("k", "v")} for i in range(n)]
    return out


def lm_cache_to_numpy(cfg, cache) -> dict:
    """The port's decode cache in the reference's layout, as NumPy arrays
    (bfloat16 tensors as float32: cast them to the reference's dtypes)."""
    prefix, period, n_periods = plan_layers(cfg)
    block = _block_index(cfg)
    layers = cache["layers"]
    out = {"prefix": [{k: to_numpy(v) for k, v in layers[i].items()}
                      for i in range(len(prefix))],
           "period": [{k: np.stack([to_numpy(layers[block(j, p)][k])
                                    for p in range(n_periods)])
                       for k in layers[block(j, 0)]}
                      for j in range(len(period))]}
    if "cross" in cache:
        out["cross"] = {k: np.stack([to_numpy(c[k])
                                     for c in cache["cross"]])
                        for k in ("k", "v")}
    return out
