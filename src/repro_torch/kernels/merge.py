"""Merge-path sorted merges: the read spine's k-way merge (port of
``repro.kernels.merge``).

The two-way primitive is ``merge_perm``: the stable merge permutation of
two (src, dst, ts)-lexicographically sorted int32 key triples, compared
lexicographically with no 64-bit packing.  ``merge_perm_cuda`` launches the
hand-written kernel ``csrc/merge_perm.cu``; ``merge_perm_plain`` is its
plain PyTorch version (two lexicographic binary searches and a scatter);
``merge_perm`` picks by the device of the keys.

``tournament_merge`` merges k sorted record streams by a log-k tournament
of pairwise merges: adjacent streams pair in each round and an odd
straggler advances unmerged, as in the reference.  The streams are laid
end to end once, one buffer a column, and every pair of a round is merged
at once (``merge_pairs``): a pair is two adjacent streams, and its merge
occupies the same range of the next round's buffer, so the layout holds
from round to round.  ``merge_pairs_cuda`` launches the same source's
round kernel (split pass and merge, keys and payload in one launch);
``merge_pairs_plain`` is its plain version on the same buffers and round
tables.  ``merge_streams`` is the tournament of two streams.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from . import _build

#: Output slots a CTA merges (``kTile`` of ``csrc/merge_perm.cu``).
TILE = 2048
#: Payload columns a round kernel carries (``kMaxPayload``).
MAX_PAYLOAD = 8


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


def _lex_less(a1, a2, a3, b1, b2, b3, *, strict):
    lt = (a1 < b1) | ((a1 == b1) & ((a2 < b2) | ((a2 == b2) & (a3 < b3))))
    if strict is True:
        return lt
    eq = (a1 == b1) & (a2 == b2) & (a3 == b3)
    if strict is False:
        return lt | eq
    return lt | (eq & ~strict)   # a bool tensor: strict where True


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


_PROTOTYPES = {
    "merge_perm_launch": [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p] * 3,
    "merge_pairs_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] + [
        ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2,
}


def _fn(name: str):
    """A C entry point of ``csrc/merge_perm.cu``, its prototype set once."""
    return _build.bind("merge_perm", _PROTOTYPES)[name]


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
    """Launch ``csrc/merge_perm.cu``'s permutation form on the current
    stream (a split pass and the merge)."""
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
    split = torch.empty((max(1, -(-(na + nb) // TILE)),), dtype=torch.int64,
                        device=dev)
    fn = _fn("merge_perm_launch")
    rc = _build.run_on(dev, fn, *(k.data_ptr() for k in a_keys),
                       *(k.data_ptr() for k in b_keys), na, nb, acap, bcap,
                       split.data_ptr(), perm.data_ptr())
    _build.check(rc, "merge_perm")
    _build.count_launch(merge_perm_cuda)
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


# ------------------------------------------------ the tournament, batched
@dataclasses.dataclass(frozen=True)
class MergeRound:
    """One round's table: ``pairs[p] = (offset, na, nb, first tile)``, A at
    ``[offset, offset + na)`` and B right after it (nb = 0: the
    straggler); ``tile_pair[t]`` is the pair of output tile t."""

    pairs: np.ndarray       # int64 [n_pairs, 4]
    tile_pair: np.ndarray   # int32 [n_tiles]


@dataclasses.dataclass(frozen=True)
class MergePlan:
    """A tournament over k streams laid end to end: ``n`` records in all,
    one table a round, and ``merges`` pairwise merges (k - 1)."""

    n: int
    rounds: Tuple[MergeRound, ...]
    merges: int


def merge_plan(caps: Sequence[int]) -> MergePlan:
    """The round tables of a tournament over streams of these capacities,
    pairing as the reference does: adjacent streams, the straggler last."""
    caps = tuple(int(c) for c in caps)
    if not caps or min(caps) < 0:
        raise ValueError("merge_plan needs at least one capacity >= 0")
    offs = np.zeros(len(caps), np.int64)
    offs[1:] = np.cumsum(caps[:-1])
    streams = list(zip(offs.tolist(), caps))
    rounds: List[MergeRound] = []
    while len(streams) > 1:
        pairs = []
        for i in range(0, len(streams), 2):
            off, na = streams[i]
            nb = streams[i + 1][1] if i + 1 < len(streams) else 0
            pairs.append((off, na, nb))
        tab = np.zeros((len(pairs), 4), np.int64)
        tab[:, :3] = pairs
        tiles = -(-(tab[:, 1] + tab[:, 2]) // TILE)
        tab[:, 3] = np.cumsum(tiles) - tiles
        rounds.append(MergeRound(
            tab, np.repeat(np.arange(len(pairs), dtype=np.int32), tiles)))
        streams = [(int(o), int(a + b)) for o, a, b in pairs]
    return MergePlan(int(sum(caps)), tuple(rounds), len(caps) - 1)


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host table on ``dev``; to a card from pinned memory, so that the
    copy does not wait for the work queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _check_cols(cols, n: int, dev: torch.device) -> List[int]:
    """Raise unless ``cols`` are three int32 keys and at most MAX_PAYLOAD
    payload columns of 1, 4 or 8 bytes a record, each a contiguous 1-D
    tensor of ``n`` records on ``dev``; return the payload widths."""
    if len(cols) < 3 or len(cols) > 3 + MAX_PAYLOAD:
        raise ValueError(f"three key columns and at most {MAX_PAYLOAD} "
                         f"payload columns, got {len(cols)} columns")
    for i, c in enumerate(cols):
        _build.check_vector(c, f"column {i}", torch.int32 if i < 3
                            else c.dtype, dev)
        if c.shape[0] != n:
            raise ValueError(f"column {i} holds {c.shape[0]} records, "
                             f"the plan {n}")
    sizes = [c.element_size() for c in cols[3:]]
    bad = [s for s in sizes if s not in (1, 4, 8)]
    if bad:
        raise TypeError(f"payload columns of {bad[0]} bytes a record: the "
                        f"round kernel moves 1, 4 or 8")
    return sizes


def merge_pairs_cuda(cols, plan: MergePlan):
    """Every round of ``plan`` on the card, one launch of
    ``merge_pairs_launch`` a round (its split pass and its merge; counted
    once).  The round tables go to the card in one copy before the first
    round, and no round waits on the host.  The rounds ping-pong between
    ``cols`` and one more buffer of each column: ``cols`` are overwritten.
    Returns the merged columns."""
    dev = cols[0].device
    if dev.type != "cuda":
        raise ValueError("merge_pairs_cuda needs CUDA tensors")
    sizes = _check_cols(cols, plan.n, dev)
    cur = tuple(cols)
    if not plan.rounds or plan.n == 0:   # no tile to merge
        return cur
    pairs = to_device(np.concatenate([r.pairs for r in plan.rounds]), dev)
    tiles = to_device(np.concatenate([r.tile_pair for r in plan.rounds]),
                      dev)
    n_tiles = [r.tile_pair.shape[0] for r in plan.rounds]
    split = torch.empty((max(1, max(n_tiles)),), dtype=torch.int64,
                        device=dev)
    nxt = tuple(torch.empty_like(c) for c in cur)
    fn = _fn("merge_pairs_launch")
    n_pay = len(sizes)
    pay_size = (ctypes.c_int * max(1, n_pay))(*sizes)

    def ptrs(ts):
        return (ctypes.c_void_p * max(1, len(ts)))(*(t.data_ptr()
                                                     for t in ts))

    pair_at = tile_at = 0
    for rnd, nt in zip(plan.rounds, n_tiles):
        rc = _build.run_on(
            dev, fn, ptrs(cur[:3]), ptrs(nxt[:3]), ptrs(cur[3:]),
            ptrs(nxt[3:]), pay_size, n_pay,
            pairs.data_ptr() + pair_at * pairs.element_size() * 4,
            tiles.data_ptr() + tile_at * tiles.element_size(), nt,
            split.data_ptr())
        _build.check(rc, "merge_pairs")
        _build.count_launch(merge_pairs_cuda)
        pair_at += rnd.pairs.shape[0]
        tile_at += nt
        cur, nxt = nxt, cur
    return cur


merge_pairs_cuda.launches = 0


def _expand(values, counts, n: int, dev) -> torch.Tensor:
    """``values[i]`` repeated ``counts[i]`` times: n int64 entries."""
    return torch.repeat_interleave(to_device(values, dev),
                                   to_device(counts, dev), output_size=n)


def _round_plain(cols, tab: np.ndarray, n: int):
    """One round by the plain rule: each record's rank in its partner
    stream (A's: #(B < a), B's: #(A <= b)), found by a lexicographic
    bisection bounded to the partner's range.  In a pair whose B starts at
    m, record e then lands at e + lo - m, where lo is the bisection's end
    in the buffer (A's partner starts at m, B's partner ends there)."""
    dev = cols[0].device
    off, na, nb = tab[:, 0], tab[:, 1], tab[:, 2]
    mid = off + na
    # Segments in buffer order: A then B of every pair.
    seg_len = np.stack([na, nb], 1).reshape(-1)
    lo0 = np.stack([mid, off], 1).reshape(-1)
    hi0 = np.stack([mid + nb, mid], 1).reshape(-1)
    is_a = np.stack([np.ones_like(na), np.zeros_like(nb)], 1).reshape(-1)
    lo = _expand(lo0, seg_len, n, dev)
    hi = _expand(hi0, seg_len, n, dev)
    m_e = _expand(np.repeat(mid, 2), seg_len, n, dev)
    strict = _expand(is_a, seg_len, n, dev).bool()
    k1, k2, k3 = cols[:3]
    steps = int(max(na.max(initial=0), nb.max(initial=0))).bit_length() + 1
    for _ in range(steps):
        open_ = lo < hi
        m = ((lo + hi) // 2).clamp(max=max(n - 1, 0))
        go = _lex_less(k1[m], k2[m], k3[m], k1, k2, k3,
                       strict=strict) & open_
        lo = torch.where(go, m + 1, lo)
        hi = torch.where(go | ~open_, hi, m)
    pos = torch.arange(n, dtype=torch.int64, device=dev) + lo - m_e
    return tuple(torch.empty_like(c).index_copy_(0, pos, c) for c in cols)


def merge_pairs_plain(cols, plan: MergePlan):
    """Plain version of ``merge_pairs_cuda`` on the same laid-out columns
    and round tables (any dtype of payload; ``cols`` are not changed)."""
    cur = tuple(cols)
    for rnd in plan.rounds:
        cur = _round_plain(cur, rnd.pairs, plan.n)
    return cur


def merge_pairs(cols, plan: MergePlan):
    """Every round of a tournament over streams laid end to end in
    ``cols`` (three int32 keys, then payload): the kernel for CUDA
    tensors, which may overwrite ``cols``, the plain version for CPU
    tensors.  Returns the merged columns, ``plan.n`` records each."""
    if cols[0].is_cuda:
        return merge_pairs_cuda(cols, plan)
    return merge_pairs_plain(cols, plan)


def lay_out(streams: Sequence[Tuple[torch.Tensor, ...]]):
    """The streams end to end, one buffer a column, and their capacities."""
    caps = [int(s[0].shape[0]) for s in streams]
    cols = tuple(torch.cat([s[j] for s in streams])
                 for j in range(len(streams[0])))
    return cols, caps


def merge_laid_out(cols, caps: Sequence[int]):
    """The tournament over streams already laid end to end in ``cols``
    (which it may overwrite), with capacities ``caps``."""
    plan = merge_plan(caps)
    MERGE_STATS.bump("kernel_merge", plan.merges)
    return merge_pairs(tuple(cols), plan)


def merge_streams(a_cols: Tuple[torch.Tensor, ...],
                  b_cols: Tuple[torch.Tensor, ...]):
    """Merge two sorted record streams into one, payload included.

    ``a_cols``/``b_cols``: tuples whose first three columns are the int32
    lexicographic sort keys; remaining columns are payload.  Every slot
    participates (capacity == validity): pad records must carry key
    columns that sort to the tail.  Returns the merged column tuple of
    length len(a) + len(b)."""
    return tournament_merge([a_cols, b_cols])


def tournament_merge(streams: Sequence[Tuple[torch.Tensor, ...]]):
    """log-k tournament of pairwise merge-path passes over k sorted streams.

    Adjacent streams pair per round; an odd straggler advances unmerged.
    Pairing is order-preserving and each pairwise pass is stable (A's ties
    first), so the tournament as a whole is stable: records with equal keys
    come out in stream order, byte-identical to a stable lexsort of the
    concatenation.  The streams are laid end to end once and each round
    merges every pair at once (``merge_pairs``)."""
    streams = [tuple(s) for s in streams]
    if not streams:
        raise ValueError("tournament_merge needs at least one stream")
    if len(streams) == 1:
        return streams[0]
    return merge_laid_out(*lay_out(streams))
