"""Public entry points of the port's kernels.

Dispatch is by the device of the input tensors, never by what the machine
has: a CUDA tensor goes to the hand-written kernel (or the call raises), a
CPU tensor goes to the kernel's plain PyTorch version.  There is no
fallback from the kernel to the plain version.
"""
from __future__ import annotations

from typing import Dict

from .merge import (lex_searchsorted, merge_laid_out, merge_pairs,
                    merge_pairs_cuda, merge_perm, merge_perm_cuda,
                    merge_streams, tournament_merge)
from .presence import presence_matrix, presence_matrix_cuda
from . import flash_attention as _flash
from . import hash_claim as _hash_claim
from . import lookup as _lookup
from . import segment_reduce as _segred

#: Every kernel wrapper of the port, by kernel name.
KERNELS = {"presence_matrix": presence_matrix_cuda,
           "merge_perm": merge_perm_cuda,
           "merge_pairs": merge_pairs_cuda,
           "gather_segsum": _segred.gather_segsum_cuda,
           "gather_segmin": _segred.gather_segmin_cuda,
           "gather_segsum_runs": _segred.gather_segsum_runs_cuda,
           "batched_searchsorted": _lookup.batched_searchsorted_cuda,
           "batched_searchsorted_runs":
               _lookup.batched_searchsorted_runs_cuda,
           "flash_attention": _flash.flash_attention_cuda,
           "hash_claim": _hash_claim.claim_rows_cuda}


def gather_segsum(dst, seg_id, wt, x, *, n_out: int,
                  use_pallas: bool = True):
    """Fused message gather + CSR segment sum (analytics inner loop).
    ``use_pallas`` keeps the reference's keyword: True is the kernel
    wrapper (dispatch by device), False the plain version."""
    if not use_pallas:
        return _segred.gather_segsum_ref(dst, seg_id, wt, x, n_out)
    return _segred.gather_segsum(dst, seg_id, wt, x, n_out=n_out)


def gather_segsum_runs(dst, seg_id, wt, x, *, n_out: int,
                       use_pallas: bool = True):
    """Segment sum over every run's records laid end to end (``seg_id``
    sorted within each run), in one launch: the sum of one
    ``gather_segsum`` a run.  ``use_pallas`` as for ``gather_segsum``."""
    if not use_pallas:
        return _segred.gather_segsum_runs_ref(dst, seg_id, wt, x, n_out)
    return _segred.gather_segsum_runs(dst, seg_id, wt, x, n_out=n_out)


def gather_segmin(dst, seg_id, wt, x, *, n_out: int,
                  use_pallas: bool = True):
    """Segment-min relaxation (BFS / SSSP / CC inner loop); ``use_pallas``
    as for ``gather_segsum``."""
    if not use_pallas:
        return _segred.gather_segmin_ref(dst, seg_id, wt, x, n_out)
    return _segred.gather_segmin(dst, seg_id, wt, x, n_out=n_out)


def batched_searchsorted(keys, queries, n_keys, *, use_pallas: bool = True):
    """Batched binary search (the no-index ablation probe); ``use_pallas``
    as for ``gather_segsum``."""
    if not use_pallas:
        return _lookup.batched_searchsorted_ref(keys, queries, n_keys)
    return _lookup.batched_searchsorted(keys, queries, n_keys)


def batched_searchsorted_runs(keys, offs, n_keys, queries, *,
                              use_pallas: bool = True):
    """The batched search into every run laid end to end, int32[R, B], in
    one launch: row r is ``batched_searchsorted`` into run r.
    ``use_pallas`` as for ``gather_segsum``."""
    if not use_pallas:
        return _lookup.batched_searchsorted_runs_ref(keys, offs, n_keys,
                                                     queries)
    return _lookup.batched_searchsorted_runs(keys, offs, n_keys, queries)


def attention(q, k, v, *, causal: bool = True, scale=None,
              use_pallas: bool = False):
    """Blocked attention.  As in the reference, the plain version is the
    default; ``use_pallas=True`` is the kernel wrapper (dispatch by
    device)."""
    if not use_pallas:
        return _flash.mha_ref(q, k, v, causal=causal, scale=scale)
    return _flash.flash_attention(q, k, v, causal=causal, scale=scale)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last ``reset_launches`` (plain-version
    calls on CPU tensors are not launches)."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = ["gather_segsum", "gather_segsum_runs", "gather_segmin",
           "presence_matrix",
           "batched_searchsorted", "batched_searchsorted_runs", "attention",
           "merge_perm", "merge_streams", "merge_pairs", "merge_laid_out",
           "tournament_merge", "lex_searchsorted", "launch_counts",
           "reset_launches", "KERNELS"]
