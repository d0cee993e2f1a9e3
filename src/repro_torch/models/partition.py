"""Activation-sharding context for model code (the port of
``repro.models.partition``).

Model functions call ``constrain(x, *spec)`` at the points where the
reference pins a layout (block boundaries, logits, attention scores, MoE
dispatch, the SSD's chunk views).  Outside a mesh context every call returns
its input, so single-device runs are untouched, bit for bit.

Inside ``shard_context(mesh)`` (a ``torch.distributed`` ``DeviceMesh``,
usually over the fake process group of ``repro_torch.launch.mesh``) the
activations are ``DTensor``s, and ``constrain`` redistributes one to the
resolved placements: ``"dp"`` becomes the data-parallel bundle (``pod`` and
``data`` on the multi-pod mesh), ``"model"`` the tensor/expert-parallel
axis, and an axis that does not divide its dim, or that the mesh lacks, is
dropped (replicated), as ``launch.shardings`` does for parameters.

Where an op has no DTensor sharding strategy, the model runs it through
``local``: the inputs are redistributed to stated placements, the function
runs on each device's local tensors, and its outputs come back as DTensors
with stated placements.  Each such point is named, and the context records
the names (``replicated_at``), so a dry run's record says where the layout
was forced by hand.  The layouts DTensor's cost model would not pick by
itself are explicit too: the FSDP weight gather (``fsdp_gather``),
sequence parallelism's gather and reduce-scatter around a product
(``gather_seq``, ``settle``) and the partial softmax over key-split scores
(``softmax``).  Every helper here is the identity, or the old code, off a
mesh.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import torch

_state = threading.local()


def current_mesh():
    """The ``DeviceMesh`` of the innermost ``shard_context``, or ``None``."""
    return getattr(_state, "mesh", None)


def replicated_at() -> List[str]:
    """The names of the ``local`` points run in the current context."""
    return getattr(_state, "points", [])


def _note(name: str) -> None:
    if name not in _state.points:
        _state.points.append(name)


@contextlib.contextmanager
def shard_context(mesh):
    """Run model code on ``mesh`` (``None``: no mesh).  Plain tensors that
    meet DTensors inside it (positions, masks, constants) count as
    replicated."""
    prev = (current_mesh(), getattr(_state, "points", []))
    _state.mesh, _state.points = mesh, []
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _state.mesh, _state.points = prev


def axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s axis names (or any mesh's ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _dp_bundle(mesh):
    names = [a for a in axis_names(mesh) if a in ("pod", "data")]
    return tuple(names) if len(names) > 1 else (names[0] if names else None)


def _axsize(mesh, ax) -> int:
    if ax is None:
        return 1
    names = axis_names(mesh)
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= mesh.shape[names.index(a)]
        return n
    return mesh.shape[names.index(ax)]


def resolve(mesh, shape: Sequence[int], spec: Sequence) -> Tuple:
    """``spec`` with ``"dp"`` resolved and every axis that the mesh lacks
    or that does not divide its dim dropped, padded with ``None`` to
    ``len(shape)``."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax == "dp":
            ax = _dp_bundle(mesh)
        if ax is not None and "model" == ax and \
                "model" not in axis_names(mesh):
            ax = None
        if ax is not None and dim % _axsize(mesh, ax) != 0:
            ax = None
        out.append(ax)
    return tuple(out) + (None,) * (len(shape) - len(out))


def placements(mesh, spec: Sequence) -> list:
    """A resolved spec (one axis name, tuple of names or ``None`` for each
    tensor dim) as DTensor placements, one for each mesh dim: ``Shard(i)``
    where tensor dim ``i`` names that axis, else ``Replicate()``.  A dim
    over several axes is split major to minor in the mesh's order, as a
    ``PartitionSpec`` tuple is."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        pl = Replicate()
        for i, ax in enumerate(spec):
            if ax == name or (isinstance(ax, tuple) and name in ax):
                pl = Shard(i)
        out.append(pl)
    return out


def _redistribute(x, mesh, spec):
    from torch.distributed.tensor import DTensor, distribute_tensor
    pls = placements(mesh, resolve(mesh, x.shape, spec))
    if isinstance(x, DTensor):
        if list(x.placements) == pls:
            return x
        return x.redistribute(mesh, pls)
    return distribute_tensor(x, mesh, pls)


def constrain(x, *spec):
    """Redistribute ``x`` to ``spec`` on the current mesh (``x`` itself
    outside one)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    return _redistribute(x, mesh, spec)


def _replace(x, fn):
    """``x`` redistributed to ``fn(mesh axis index, placement)`` for each
    of its placements; ``x`` itself outside a mesh, when it is not a
    DTensor, or when nothing changes."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    pls = [fn(i, p) for i, p in enumerate(x.placements)]
    return x if pls == list(x.placements) else x.redistribute(mesh, pls)


def _gathered(dim: int, where=lambda i: True):
    """A ``_replace`` rule: a shard of ``dim`` (on the axes ``where``
    picks) becomes a replica."""
    from torch.distributed.tensor import Replicate, Shard
    return lambda i, p: (Replicate() if isinstance(p, Shard) and
                         p.dim == dim and where(i) else p)


def fsdp_gather(w):
    """A weight with its data-parallel shards gathered (FSDP's all-gather
    before use; its backward reduce-scatters the gradient), its ``model``
    shards kept."""
    mesh = current_mesh()
    if mesh is None:
        return w
    from torch.distributed.tensor import Replicate, Shard
    return _replace(w, lambda i, p: (
        Replicate() if isinstance(p, Shard) and
        axis_names(mesh)[i] != "model" else p))


def complete(y):
    """``y`` with its partial reductions completed (all-reduced)."""
    if current_mesh() is None:
        return y
    from torch.distributed.tensor import Partial, Replicate
    return _replace(y, lambda i, p: (Replicate() if isinstance(p, Partial)
                                     else p))


def gather_seq(x):
    """A 3-D activation with its sequence dim (dim 1) gathered (sequence
    parallelism's all-gather before a product), its other dims as they
    are."""
    if current_mesh() is None or x.dim() < 3:
        return x
    return _replace(x, _gathered(1))


def whole_last(x):
    """``x`` with its last dim gathered (a norm reduces over it)."""
    if current_mesh() is None:
        return x
    return _replace(x, _gathered(x.dim() - 1))


def softmax(x, dtype):
    """``softmax(x.float(), -1).to(dtype)``.  On a mesh whose axes split
    the last dim (key-split attention scores) it is written out, so that
    the max and the sum are partial reductions completed by small
    all-reduces and the scores stay split (the reference's partial
    softmax and combine)."""
    if current_mesh() is None:
        return torch.softmax(x.float(), -1).to(dtype)
    from torch.distributed.tensor import DTensor, Shard
    if not (isinstance(x, DTensor) and any(
            isinstance(p, Shard) and p.dim == x.dim() - 1
            for p in x.placements)):
        return torch.softmax(x.float(), -1).to(dtype)
    xf = x.float()
    m = complete(xf.detach().amax(-1, keepdim=True))
    e = torch.exp(xf - m)
    return (e / complete(e.sum(-1, keepdim=True))).to(dtype)


def settle(y):
    """A product's output with its partial sums over an axis reduced: onto
    the sequence dim (dim 1) when the axis splits it, else replicated
    (sequence parallelism's reduce-scatter, or an all-reduce).  ``y``
    itself outside a mesh or when nothing is partial."""
    mesh = current_mesh()
    if mesh is None:
        return y
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(y, DTensor) or \
            not any(isinstance(p, Partial) for p in y.placements):
        return y
    pls = list(y.placements)
    taken = {p.dim for p in pls if isinstance(p, Shard)}
    for i, p in enumerate(pls):
        if isinstance(p, Partial):
            if y.dim() > 2 and 1 not in taken and \
                    y.shape[1] % mesh.shape[i] == 0:
                pls[i] = Shard(1)
                taken.add(1)
            else:
                pls[i] = Replicate()
    return y.redistribute(mesh, pls)


def split_keys(k, n_heads: int):
    """Keys or values [B, S, H, D] for attention scores: on a mesh whose
    ``model`` axis cannot split the ``n_heads`` query heads, the sequence
    over ``model`` (so the key-split scores of ``constrain_scores`` are
    made split, not sliced from whole ones).  ``k`` itself otherwise."""
    mesh = current_mesh()
    if mesh is None or "model" not in axis_names(mesh) or \
            n_heads % _axsize(mesh, "model") == 0:
        return k
    return constrain(k, "dp", "model", None, None)


def constrain_scores(s):
    """Attention scores (B, H, Q, K): H over ``model`` when it divides,
    else the key dim (few-KV or odd-head archs such as Qwen2-1.5B's 12
    heads on a 16-way model axis)."""
    mesh = current_mesh()
    if mesh is None:
        return s
    msize = _axsize(mesh, "model") if "model" in axis_names(mesh) else 1
    if s.shape[1] % msize == 0:
        return constrain(s, "dp", "model", None, None)
    return constrain(s, "dp", None, None, "model")


def local(name: str, fn: Callable, args: Sequence, in_specs: Sequence,
          out_specs: Sequence, partial: Optional[str] = None):
    """``fn(*args)`` run on each device's local tensors, for an op with no
    DTensor sharding strategy.  Outside a mesh it is ``fn(*args)``.
    Inside one, each tensor of ``args`` is redistributed to its spec of
    ``in_specs`` (``None``: not a tensor), ``fn`` runs on the local shards,
    and each output becomes a DTensor of its spec of ``out_specs`` (a
    single output: a one-element sequence); with ``partial``, each output
    is a partial sum over that axis.  The point's ``name`` joins
    ``replicated_at()``.  Autograd passes through."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor
    ins, applied = [], set()
    for a, sp in zip(args, in_specs):
        if sp is None:
            ins.append(a)
            continue
        res = resolve(mesh, a.shape, sp)
        for ax in res:
            applied.update(ax if isinstance(ax, tuple) else (ax,))
        a = _redistribute(a, mesh, sp)
        ins.append(a.to_local())
    # fn sees local tensors: no mesh paths, but ``axis_rank`` still reads
    # this device's coordinates.
    _state.mesh, _state.inside = None, mesh
    try:
        out = fn(*ins)
    finally:
        _state.mesh, _state.inside = mesh, None
    single = not isinstance(out, (tuple, list))
    outs = [out] if single else list(out)
    wrapped = []
    for o, sp in zip(outs, out_specs):
        if sp is None:
            wrapped.append(o)
            continue
        # The local shapes times the shard counts give the global shape.
        pls = placements(mesh, _local_spec(mesh, o.shape, sp, applied))
        if partial is not None:
            from torch.distributed.tensor import Partial
            pls[axis_names(mesh).index(partial)] = Partial()
        wrapped.append(DTensor.from_local(o, mesh, pls, run_check=False))
    _note(name)
    return wrapped[0] if single else tuple(wrapped)


def split_last(t, *sizes):
    """``t`` with its last dim split into ``sizes`` (heads x head dim).
    On a mesh, a last dim split over an axis that does not divide
    ``sizes[0]`` is gathered first (DTensor cannot split it unevenly)."""
    mesh = current_mesh()
    if mesh is not None:
        t = _replace(t, _gathered(t.dim() - 1,
                                  lambda i: sizes[0] % mesh.shape[i]))
    return t.reshape(tuple(t.shape[:-1]) + tuple(sizes))


#: The decode caches' layouts (the reference's ``cache_pspecs``, its
#: stacked layer axis left out): the SSM state ``h`` [B, H, N, P] heads over
#: ``model``, the conv tail [B, K-1, C] over the batch alone, and every
#: k/v/latent cache [B, S, ...] its sequence over ``model``.
CACHE_SPECS = {"h": ("dp", "model"), "conv": ("dp",)}
CACHE_DEFAULT = ("dp", "model")


def cache_spec(name: str) -> Tuple:
    return CACHE_SPECS.get(name, CACHE_DEFAULT)


def cache_zeros(name: str, shape, dtype, device):
    """A zero cache tensor: plain outside a mesh, else a DTensor laid out
    by ``cache_spec(name)`` that allocates only each device's shard."""
    mesh = current_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import zeros
    return zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                 placements=placements(mesh, resolve(mesh, shape,
                                                     cache_spec(name))))


def fill_prefix(dst, new):
    """``dst[:, :S] = new`` (S = ``new.shape[1]``), in place; returns
    ``dst``.  On a mesh ``new`` is padded to ``dst``'s length and laid out
    as ``dst`` is, and each device copies its shard."""
    s = new.shape[1]
    mesh = current_mesh()
    if mesh is None:
        dst[:, :s] = new.to(dst.dtype)
        return dst
    new = new.to(dst.dtype)
    if s < dst.shape[1]:
        new = torch.nn.functional.pad(
            new, (0, 0) * (new.dim() - 2) + (0, dst.shape[1] - s))
    new = new.redistribute(mesh, dst.placements)
    dst.to_local().copy_(new.to_local())
    _note("cache_fill")
    return dst


def write_slot(dst, slot: int, new):
    """``dst[:, slot] = new[:, 0]``, in place; returns ``dst``.  On a mesh
    whose axes split ``dst``'s dim 1, only the device that holds ``slot``
    writes it."""
    mesh = current_mesh()
    if mesh is None:
        dst[:, slot:slot + 1] = new.to(dst.dtype)
        return dst
    from torch.distributed.tensor import Shard
    local_dst = dst.to_local()
    lo, n = 0, local_dst.shape[1]
    for i, p in enumerate(dst.placements):
        if isinstance(p, Shard) and p.dim == 1:
            lo = lo * mesh.shape[i] + mesh.get_local_rank(i)
    lo *= n
    rule = _gathered(1)
    new = new.to(dst.dtype).redistribute(
        mesh, [rule(i, p) for i, p in enumerate(dst.placements)]).to_local()
    if lo <= slot < lo + n:
        local_dst[:, slot - lo:slot - lo + 1] = new
    _note("cache_write")
    return dst


def merge_last(t):
    """``t`` with its last two dims merged into one (heads x head dim ->
    width).  On a mesh the merged tensor passes through a redistribution
    to its own layout: a no-op forward, whose backward brings the
    gradient (split over ``model`` by the product that reads it) back to
    that layout before the split that undoes the merge."""
    mesh = current_mesh()
    if mesh is not None:
        # The merged dims must not be split unevenly, the inner one not at
        # all (a head count the model axis does not divide).
        from torch.distributed.tensor import Replicate, Shard
        h = t.dim() - 2
        t = _replace(t, lambda i, p: (
            Replicate() if isinstance(p, Shard) and (
                p.dim == h + 1 or (p.dim == h and t.shape[h] %
                                   mesh.shape[i])) else p))
    out = t.reshape(tuple(t.shape[:-2]) + (t.shape[-2] * t.shape[-1],))
    if mesh is None:
        return out
    from torch.distributed.tensor import DTensor
    if not isinstance(out, DTensor):
        return out
    return out.redistribute(mesh, list(out.placements))


def divides(n: int, ax) -> bool:
    """Whether ``ax`` of the current mesh splits a dim of ``n``."""
    mesh = current_mesh()
    return mesh is not None and ax in axis_names(mesh) and \
        n % _axsize(mesh, ax) == 0


def axis_rank(ax: str) -> int:
    """This device's coordinate on ``ax`` of the current mesh (inside
    ``local``, of the mesh it runs on)."""
    mesh = getattr(_state, "inside", None) or current_mesh()
    return mesh.get_local_rank(ax)


def _local_spec(mesh, local_shape, spec, applied):
    """An output's ``spec`` for its LOCAL shape: an axis names a dim it
    splits (the global dim is the local one times the axis size), kept
    only where some input was split by it (``applied``)."""
    out = []
    for ax in list(spec) + [None] * (len(local_shape) - len(spec)):
        if ax == "dp":
            ax = _dp_bundle(mesh)
        if ax is not None and not set(
                ax if isinstance(ax, tuple) else (ax,)) <= applied:
            ax = None
        out.append(ax)
    return tuple(out)


__all__ = ["current_mesh", "shard_context", "constrain", "constrain_scores",
           "local", "replicated_at", "resolve", "placements", "complete",
           "fsdp_gather", "gather_seq", "whole_last", "settle", "softmax",
           "split_keys", "split_last", "merge_last", "cache_spec",
           "cache_zeros", "fill_prefix", "write_slot", "divides"]
