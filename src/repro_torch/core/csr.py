"""CSR run construction, lookup and merge (paper §2.2, §4.2.1).

The port of ``repro.core.csr``.  A run is always sorted by (src, dst, ts);
invalid slots carry src == INVALID_VID so they sort to the tail.  Torch has
no ``lexsort``: ``lexsort_edges`` is three stable sorts (ts, then dst, then
src), which orders ties by position exactly as ``jnp.lexsort`` does.  Every
count and index is cast back to int32, so run arrays are byte-equal to the
JAX package's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .types import INVALID_VID, CSRRunArrays, scalar

_I32 = torch.int32


def lexsort_edges(src: torch.Tensor, dst: torch.Tensor,
                  ts: torch.Tensor) -> torch.Tensor:
    """Stable order: src asc, then dst asc, then ts asc (int64 permutation)."""
    order = torch.argsort(ts, stable=True)
    order = order[torch.argsort(dst[order], stable=True)]
    return order[torch.argsort(src[order], stable=True)]


def stable_partition(keep: torch.Tensor) -> torch.Tensor:
    """Permutation moving the True entries of ``keep`` to the front, both
    halves in their original order (``jnp.argsort(~keep, stable=True)``)."""
    return torch.argsort((~keep).to(torch.int8), stable=True)


def _unique_padded(sorted_vals: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.unique(x, size=size, fill_value=INVALID_VID)`` of a sorted
    int32 vector: its distinct values, truncated or padded to ``size``."""
    u = torch.unique_consecutive(sorted_vals)
    if u.shape[0] >= size:
        return u[:size]
    pad = torch.full((size - u.shape[0],), INVALID_VID, dtype=_I32,
                     device=u.device)
    return torch.cat([u, pad])


def build_run_arrays(src, dst, ts, marker, prop, n, *,
                     vcap: int) -> CSRRunArrays:
    """Sort raw edges into a CSR run. Entries at positions >= n are ignored."""
    ecap = src.shape[0]
    dev = src.device
    n_t = torch.as_tensor(n, dtype=_I32, device=dev)
    valid = torch.arange(ecap, dtype=_I32, device=dev) < n_t
    src = torch.where(valid, src, INVALID_VID).to(_I32)
    order = lexsort_edges(src, dst, ts)
    src_s = src[order]
    vo = valid[order]
    dst_s = torch.where(vo, dst[order], 0).to(_I32)
    ts_s = torch.where(vo, ts[order], 0).to(_I32)
    marker_s = vo & marker[order]
    prop_s = torch.where(vo, prop[order], 0.0).to(torch.float32)
    vkeys = _unique_padded(src_s, vcap)
    # Pads are INVALID_VID; searchsorted('left') lands them on the first pad
    # edge position == n, yielding empty slices — no masking needed.
    voff = torch.searchsorted(src_s, vkeys).to(_I32)
    voff_full = torch.cat([voff, n_t.reshape(1)])
    nv = (vkeys != INVALID_VID).sum().to(_I32)
    return CSRRunArrays(vkeys=vkeys, voff=voff_full, dst=dst_s, ts=ts_s,
                        marker=marker_s, prop=prop_s, nv=nv, ne=n_t.clone())


def run_lookup(run: CSRRunArrays, v) -> Tuple[torch.Tensor, ...]:
    """(found, start, end) of vertex v's edge slice."""
    v = torch.as_tensor(v, dtype=_I32, device=run.vkeys.device).reshape(1)
    i = torch.searchsorted(run.vkeys, v)
    i_c = i.clamp(max=run.vcap - 1)
    found = run.vkeys[i_c] == v
    start = torch.where(found, run.voff[i_c], 0)
    end = torch.where(found, run.voff[i_c + 1], 0)
    return found[0], start[0].to(_I32), end[0].to(_I32)


def run_lookup_batch(run: CSRRunArrays, vs: torch.Tensor, *,
                     use_pallas: bool = False):
    """Vectorized `run_lookup`: (found, start, end) for a whole int32 query
    vector in one binary-search pass; ``use_pallas`` takes the batched
    bisection kernel (``kernels.lookup``, dispatch by device), which reads
    ``run.nv`` on the device.  Pad slots (INVALID_VID) report not-found."""
    if use_pallas:
        from ..kernels import ops as kops
        i = kops.batched_searchsorted(run.vkeys, vs, run.nv)
    else:
        i = torch.searchsorted(run.vkeys, vs)
    i_c = i.clamp(max=run.vcap - 1).long()
    found = (run.vkeys[i_c] == vs) & (vs != INVALID_VID)
    start = torch.where(found, run.voff[i_c], 0).to(_I32)
    end = torch.where(found, run.voff[i_c + 1], 0).to(_I32)
    return found, start, end


def runs_lookup_batch(runs: Sequence[CSRRunArrays], vs: torch.Tensor, *,
                      use_pallas: bool = True):
    """``run_lookup_batch`` of ``vs`` in every run at once: (found, start,
    end) as [R, B], row r equal to ``run_lookup_batch(runs[r], vs)``.  The
    runs' ``vkeys`` and ``voff`` are laid end to end and searched by one
    ``batched_searchsorted_runs`` (``use_pallas``: the kernel, dispatch by
    device; else its plain version), with each run's ``nv`` read on the
    device; the run table goes to the device in one copy."""
    from ..kernels import ops as kops
    dev = vs.device
    vcap = np.array([a.vcap for a in runs], np.int64)
    koff = np.cumsum(vcap) - vcap
    tab = torch.from_numpy(np.stack([koff, koff + np.arange(len(runs)),
                                     vcap])).to(dev)
    koff_t, ooff_t, vcap_t = tab.unbind(0)
    vkeys = torch.cat([a.vkeys for a in runs])
    voff = torch.cat([a.voff for a in runs])
    nv = torch.stack([a.nv for a in runs]).to(_I32)
    i = kops.batched_searchsorted_runs(vkeys, koff_t, nv, vs,
                                       use_pallas=use_pallas)
    i_c = torch.minimum(i, (vcap_t - 1)[:, None])
    found = (vkeys[koff_t[:, None] + i_c] == vs) & (vs != INVALID_VID)
    at = ooff_t[:, None] + i_c
    start = torch.where(found, voff[at], 0).to(_I32)
    end = torch.where(found, voff[at + 1], 0).to(_I32)
    return found, start, end


def run_gather(run: CSRRunArrays, start, end, *, cap: int):
    """Gather up to `cap` edge records from [start, end)."""
    dev = run.dst.device
    idx = torch.as_tensor(start, dtype=torch.int64, device=dev) + \
        torch.arange(cap, device=dev)
    m = idx < torch.as_tensor(end, dtype=torch.int64, device=dev)
    idx_c = idx.clamp(max=run.ecap - 1)
    return (torch.where(m, run.dst[idx_c], INVALID_VID).to(_I32),
            torch.where(m, run.ts[idx_c], 0).to(_I32),
            m & run.marker[idx_c],
            torch.where(m, run.prop[idx_c], 0.0),
            m)


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x moved right by k (k < 0: left), the vacated slots set to fill."""
    out = torch.roll(x, k)
    if k > 0:
        out[:k] = fill
    else:
        out[k:] = fill
    return out


def gc_keep_mask(src, dst, ts, marker, valid, tau_min: int,
                 is_bottom: bool) -> torch.Tensor:
    """Version-retention GC over (src,dst,ts)-sorted records.

    1. Drop a record iff a newer record of the same (src,dst) exists with
       ts <= tau_min (superseded before any live snapshot could see it).
    2. PAIR ANNIHILATION: a newest-of-key tombstone (ts <= tau_min) is
       dropped together with the insert it supersedes when the record
       preceding that insert is absent or itself a delete.
    3. At the bottom level every dead newest-of-key tombstone drops.
    """
    nxt_same = (valid & _shift(valid, -1, False)
                & (src == torch.roll(src, -1)) & (dst == torch.roll(dst, -1)))
    nxt_same[-1:] = False
    superseded = nxt_same & (torch.roll(ts, -1) <= tau_min)
    keep = valid & ~superseded
    newest = ~nxt_same
    prev_same = _shift(nxt_same, 1, False)
    prev_marker = _shift(marker, 1, False)
    prev2_same = _shift(nxt_same, 2, False)
    prev2_marker = _shift(marker, 2, False)
    pair_safe = prev_same & ~prev_marker & (~prev2_same | prev2_marker)
    dead_tomb = marker & newest & (ts <= tau_min)
    if not is_bottom:
        dead_tomb = dead_tomb & pair_safe
    return keep & ~dead_tomb


def _merge_impl(src, dst, ts, marker, prop, valid, tau_min: int, *,
                vcap: int, is_bottom: bool) -> CSRRunArrays:
    src = torch.where(valid, src, INVALID_VID).to(_I32)
    order = lexsort_edges(src, dst, ts)
    src, dst, ts = src[order], dst[order], ts[order]
    marker, prop, valid = marker[order], prop[order], valid[order]
    keep = gc_keep_mask(src, dst, ts, marker, valid, tau_min, is_bottom)
    src = torch.where(keep, src, INVALID_VID).to(_I32)
    n = keep.sum().to(_I32)
    # Stable compaction of survivors to a dense prefix.
    order2 = stable_partition(keep)
    return build_run_arrays(src[order2], dst[order2], ts[order2],
                            marker[order2], prop[order2], n, vcap=vcap)


def merge_runs(runs: Sequence[CSRRunArrays], tau_min: int, *, vcap: int,
               is_bottom: bool = False) -> CSRRunArrays:
    """Vertex-aware compaction merge of k runs into one (paper Example 1).

    The result keeps every version still visible to a snapshot >= tau_min and
    annihilates superseded versions / dead tombstones."""
    dev = runs[0].dst.device
    src = torch.cat([expand_src(r) for r in runs])
    dst = torch.cat([r.dst for r in runs])
    ts = torch.cat([r.ts for r in runs])
    marker = torch.cat([r.marker for r in runs])
    prop = torch.cat([r.prop for r in runs])
    valid = torch.cat([torch.arange(r.ecap, dtype=_I32, device=dev) < r.ne
                       for r in runs])
    return _merge_impl(src, dst, ts, marker, prop, valid, int(tau_min),
                       vcap=vcap, is_bottom=is_bottom)


def expand_src(run: CSRRunArrays) -> torch.Tensor:
    """Recover the per-edge src array from (vkeys, voff): src[e] = vkeys[j]
    for voff[j] <= e < voff[j+1].  One searchsorted — the inverse of CSR."""
    e = torch.arange(run.ecap, dtype=_I32, device=run.dst.device)
    j = torch.searchsorted(run.voff[1:], e, right=True).clamp(
        max=run.vcap - 1)
    return torch.where(e < run.ne, run.vkeys[j], INVALID_VID).to(_I32)


def run_slice_vertex_range(run: CSRRunArrays, lo: int, hi: int,
                           *, vcap: int) -> CSRRunArrays:
    """Extract the sub-run covering vertices in [lo, hi)."""
    src = expand_src(run)
    inside = (src >= lo) & (src < hi)
    order = stable_partition(inside)   # stable → keeps (src,dst,ts) order
    return build_run_arrays(src[order], run.dst[order], run.ts[order],
                            run.marker[order], run.prop[order],
                            inside.sum().to(_I32), vcap=vcap)


def empty_run(vcap: int, ecap: int, device) -> CSRRunArrays:
    return CSRRunArrays(
        vkeys=torch.full((vcap,), INVALID_VID, dtype=_I32, device=device),
        voff=torch.zeros((vcap + 1,), dtype=_I32, device=device),
        dst=torch.zeros((ecap,), dtype=_I32, device=device),
        ts=torch.zeros((ecap,), dtype=_I32, device=device),
        marker=torch.zeros((ecap,), dtype=torch.bool, device=device),
        prop=torch.zeros((ecap,), dtype=torch.float32, device=device),
        nv=scalar(0, device), ne=scalar(0, device))


def _fit(x: torch.Tensor, cap: int, fill) -> torch.Tensor:
    n = x.shape[0]
    if n == cap:
        return x
    if n > cap:
        return x[:cap]
    if isinstance(fill, torch.Tensor):
        pad = fill.reshape(1).expand(cap - n)
    else:
        pad = torch.full((cap - n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def repad_run(run: CSRRunArrays, vcap: int, ecap: int) -> CSRRunArrays:
    """Copy a run into (possibly smaller-capacity) fresh padding, keeping
    capacities in quantized buckets across compactions."""
    return CSRRunArrays(
        vkeys=_fit(run.vkeys, vcap, INVALID_VID),
        voff=_fit(run.voff, vcap + 1, run.voff[-1]),
        dst=_fit(run.dst, ecap, 0), ts=_fit(run.ts, ecap, 0),
        marker=_fit(run.marker, ecap, False),
        prop=_fit(run.prop, ecap, 0.0),
        nv=run.nv, ne=run.ne)


def quantize_cap(n: int, minimum: int = 256, half_steps: bool = False) -> int:
    """Round up to a power-of-two bucket (``half_steps`` also allows
    1.5x-power-of-two buckets) — the JAX package's capacity rule, kept so
    that both packages pad runs alike."""
    c = minimum
    while c < n:
        if half_steps and (c * 3) // 2 >= n:
            return (c * 3) // 2
        c <<= 1
    return c
