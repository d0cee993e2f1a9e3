"""Merge-path sorted merges: the read spine's k-way merge (port of
``repro.kernels.merge``).

The two-way primitive is ``merge_perm``: the stable merge permutation of
two (src, dst, ts)-lexicographically sorted int32 key triples, compared
lexicographically with no 64-bit packing.  ``merge_perm_cuda`` launches the
hand-written kernel ``csrc/merge_perm.cu``; ``merge_perm_plain`` is its
plain PyTorch version (two lexicographic binary searches and a scatter);
``merge_perm`` picks by the device of the keys.

On top of it sit ``merge_streams`` (one pairwise merge of whole record
streams: the permutation, then the payload applied by ordinary gathers
outside the kernel) and ``tournament_merge`` (a log-k tournament of
pairwise passes): k pre-sorted sources merge on the device with no sort.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .. import obs
from . import _build


class MergeStats:
    """Merge counters as a view over the port's metric registry: each key
    is backed by a monotonic ``merge_<key>_total`` counter."""

    _KEYS = ("kernel_merge", "host_lexsort", "spine_build", "spine_splice",
             "spine_reuse")

    def __init__(self, registry=None) -> None:
        self._registry = registry if registry is not None else obs.REGISTRY
        self._counters = {k: self._registry.counter(f"merge_{k}_total")
                          for k in self._KEYS}

    def bump(self, key: str, n: int = 1) -> None:
        self._counters[key].inc(n)

    def snapshot_stats(self) -> Dict[str, int]:
        """Point-in-time copy of every counter."""
        return {k: c.value for k, c in self._counters.items()}


MERGE_STATS = MergeStats()


def _lex_less(a1, a2, a3, b1, b2, b3, *, strict: bool):
    lt = (a1 < b1) | ((a1 == b1) & ((a2 < b2) | ((a2 == b2) & (a3 < b3))))
    if strict:
        return lt
    return lt | ((a1 == b1) & (a2 == b2) & (a3 == b3))


def lex_searchsorted(keys_a, q1, q2, q3, n_keys, *, side: str):
    """Vectorized lexicographic binary search of (q1,q2,q3) tuples into the
    sorted valid prefix ``keys_a[:n_keys]`` of a 3-component key set:
    int32 insertion points (``side="left"``: count of keys < q; ``"right"``:
    count of keys <= q)."""
    k1, k2, k3 = keys_a
    n = k1.shape[0]
    lo = torch.zeros(q1.shape, dtype=torch.int32, device=q1.device)
    hi = torch.full(q1.shape, int(n_keys), dtype=torch.int32,
                    device=q1.device)
    if n == 0:
        return lo
    strict = side == "left"
    for _ in range(max(1, n.bit_length() + 1)):
        open_ = lo < hi   # converged lanes must not move (fixed-step loop)
        mid = (lo + hi) // 2
        m = mid.clamp(0, n - 1).long()
        go_right = _lex_less(k1[m], k2[m], k3[m], q1, q2, q3,
                             strict=strict) & open_
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right | ~open_, hi, mid)
    return lo


def merge_perm_plain(a_keys, b_keys, na: int, nb: int) -> torch.Tensor:
    """Plain version of the merge kernel: A[i] lands at i + #(B < A[i]),
    B[j] at j + #(A <= B[j]) (ties to A); slots past na + nb hold
    acap + bcap."""
    a1, a2, a3 = a_keys
    b1, b2, b3 = b_keys
    acap, bcap = a1.shape[0], b1.shape[0]
    cap = acap + bcap
    dev = a1.device
    perm = torch.full((cap,), cap, dtype=torch.int32, device=dev)
    if na:
        ra = lex_searchsorted((b1, b2, b3), a1[:na], a2[:na], a3[:na], nb,
                              side="left")
        ia = torch.arange(na, dtype=torch.int32, device=dev)
        perm[(ia + ra).long()] = ia
    if nb:
        rb = lex_searchsorted((a1, a2, a3), b1[:nb], b2[:nb], b3[:nb], na,
                              side="right")
        ib = torch.arange(nb, dtype=torch.int32, device=dev)
        perm[(ib + rb).long()] = ib + acap
    return perm


def _check_keys(keys, name: str, device: torch.device) -> int:
    n = keys[0].shape[0]
    for k in keys:
        if k.device != device:
            raise ValueError(f"{name} is on {k.device}, expected {device}")
        if k.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {k.dtype}, expected int32")
        if k.dim() != 1 or not k.is_contiguous() or k.shape[0] != n:
            raise ValueError(f"{name}: three contiguous 1-D keys of one size")
    return n


def merge_perm_cuda(a_keys, b_keys, na: int, nb: int) -> torch.Tensor:
    """Launch ``csrc/merge_perm.cu`` on the current stream."""
    dev = a_keys[0].device
    if dev.type != "cuda":
        raise ValueError("merge_perm_cuda needs CUDA tensors")
    acap = _check_keys(a_keys, "a_keys", dev)
    bcap = _check_keys(b_keys, "b_keys", dev)
    na, nb = int(na), int(nb)
    if not (0 <= na <= acap and 0 <= nb <= bcap):
        raise ValueError("valid prefixes exceed the key capacities")
    if acap + bcap >= 1 << 31:
        raise ValueError("merge_perm indexes with int32: capacity too large")
    perm = torch.empty((acap + bcap,), dtype=torch.int32, device=dev)
    fn = _build.load("merge_perm").merge_perm_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(k.data_ptr() for k in a_keys),
                *(k.data_ptr() for k in b_keys),
                na, nb, acap, bcap, perm.data_ptr(), stream)
    _build.check(rc, "merge_perm")
    merge_perm_cuda.launches += 1
    return perm


merge_perm_cuda.launches = 0


def merge_perm(a_keys, b_keys, na, nb) -> torch.Tensor:
    """Permutation merging two lexicographically sorted key triples.

    a_keys/b_keys: (k1, k2, k3) int32 tensors (fixed caps, valid prefixes
    na/nb).  Returns perm int32[acap+bcap]: output position -> index into
    concat(A, B); slots beyond na+nb point at acap+bcap.  The kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if a_keys[0].is_cuda:
        return merge_perm_cuda(a_keys, b_keys, na, nb)
    return merge_perm_plain(a_keys, b_keys, int(na), int(nb))


def merge_streams(a_cols: Tuple[torch.Tensor, ...],
                  b_cols: Tuple[torch.Tensor, ...]):
    """Merge two sorted record streams into one, payload included.

    ``a_cols``/``b_cols``: tuples whose first three columns are the int32
    lexicographic sort keys; remaining columns are payload of any dtype.
    Every slot participates (capacity == validity): pad records must carry
    key columns that sort to the tail.  Returns the merged column tuple of
    length len(a) + len(b)."""
    na, nb = a_cols[0].shape[0], b_cols[0].shape[0]
    perm = merge_perm(tuple(a_cols[:3]), tuple(b_cols[:3]), na, nb).long()
    MERGE_STATS.bump("kernel_merge")
    return tuple(torch.cat([ca, cb]).index_select(0, perm)
                 for ca, cb in zip(a_cols, b_cols))


def tournament_merge(streams: Sequence[Tuple[torch.Tensor, ...]]):
    """log-k tournament of pairwise merge-path passes over k sorted streams.

    Adjacent streams pair per round; an odd straggler advances unmerged.
    Pairing is order-preserving and each pairwise pass is stable (A's ties
    first), so the tournament as a whole is stable: records with equal keys
    come out in stream order, byte-identical to a stable lexsort of the
    concatenation."""
    streams = [tuple(s) for s in streams]
    if not streams:
        raise ValueError("tournament_merge needs at least one stream")
    while len(streams) > 1:
        nxt = [merge_streams(streams[i], streams[i + 1])
               for i in range(0, len(streams) - 1, 2)]
        if len(streams) % 2:
            nxt.append(streams[-1])
        streams = nxt
    return streams[0]
