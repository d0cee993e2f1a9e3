"""The MemGraph insert's claim step for one chunk of vertex keys: the
deduplication and the hashmap's find-or-insert of ``core/memgraph.py``.

``claim_rows(htab_key, htab_row, n_rows, keys)`` returns ``(ukeys, inv,
htab_key, htab_row, n_rows, row, is_new, ok, rounds)``: ``ukeys, inv`` as
``torch.unique(keys, sorted=True, return_inverse=True)`` gives them, with
``ukeys`` padded to ``len(keys)`` by ``INVALID_VID``; fresh tables (the
ones given are never written: published states keep them), the new row
count, each unique key's row (-1 for the padding), whether it was
inserted, whether every key was resolved within ``MAX_PROBE_ROUNDS``, and
the claim rounds run, a 0-d int32 tensor.  The collision rule is the
reference's, round for round: an open key probes slot
``(hash(key) + probe) % hcap``; its own key there resolves it, an empty
slot makes it a claimant, a foreign key advances its probe; the smallest
unique index claiming a slot wins it, winners take rows ``n_rows, n_rows +
1, ...`` in unique-index order, losers advance.

``claim_rows_cuda`` sorts the keys and launches the cooperative kernel of
``csrc/hash_claim.cu`` once: the deduplication and every round, nothing
read to the host.  ``claim_rows_ref`` is its plain version:
``unique_padded`` and ``find_or_insert_rows_ref``, the port of
``repro.core.memgraph._find_or_insert_rows``, whose rounds run as torch ops
on the host until every key is resolved instead of a fixed 64 under
``lax.cond``.  The undecorated name picks by the device of the keys.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.types import INVALID_VID
from . import _build

_HASH_MULT = 2654435761
MAX_PROBE_ROUNDS = 64
_I32 = torch.int32


def hash_slots(v: torch.Tensor, hcap: int) -> torch.Tensor:
    """(uint32(v) * 2654435761 mod 2**32) mod hcap, as int64.  The product
    of two values below 2**32 may wrap int64, but its low 32 bits — the
    only ones kept — are exact under two's-complement wraparound."""
    x = (v.to(torch.int64) & 0xFFFFFFFF) * _HASH_MULT
    return (x & 0xFFFFFFFF) % hcap


def unique_padded(keys: torch.Tensor):
    """``torch.unique(keys, sorted=True, return_inverse=True)`` with the
    unique keys padded to ``len(keys)`` by ``INVALID_VID``: ``(ukeys,
    inv)``.  Fixed shapes, so nothing waits for the device to learn the
    unique count: a sort, a first-of-run flag, its inclusive scan (each
    key's unique index), and two scatters."""
    s, perm = torch.sort(keys)
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    run = torch.cumsum(first, 0) - 1
    ukeys = torch.full_like(s, INVALID_VID).scatter_(0, run, s)
    return ukeys, torch.empty_like(run).scatter_(0, perm, run)


def find_or_insert_rows_ref(htab_key, htab_row, n_rows, ukeys):
    """The claim rounds for unique keys as torch ops, each ended by the
    host's read of ``resolved.all()`` before the next: ``(htab_key,
    htab_row, n_rows, row, is_new, ok, rounds)``, ``rounds`` a Python
    int."""
    u = ukeys.shape[0]
    hcap = htab_key.shape[0]
    dev = ukeys.device
    base = hash_slots(ukeys, hcap)
    uidx = torch.arange(u, dtype=_I32, device=dev)
    htab_key, htab_row = htab_key.clone(), htab_row.clone()
    probe = torch.zeros(u, dtype=torch.int64, device=dev)
    row = torch.full((u,), -1, dtype=_I32, device=dev)
    is_new = torch.zeros(u, dtype=torch.bool, device=dev)
    resolved = ukeys == INVALID_VID
    rounds = 0
    while rounds < MAX_PROBE_ROUNDS and not bool(resolved.all()):
        rounds += 1
        pos = (base + probe) % hcap
        k = htab_key[pos]
        hit = ~resolved & (k == ukeys)
        row = torch.where(hit, htab_row[pos], row)
        resolved = resolved | hit
        empty = ~resolved & (k == INVALID_VID)
        # Claim round: scatter-min of unique-index into per-slot owner array.
        owner = torch.full((hcap,), u, dtype=_I32, device=dev)
        owner.scatter_reduce_(0, pos[empty], uidx[empty], "amin")
        win = empty & (owner[pos] == uidx)
        new_row = (n_rows + torch.cumsum(win.to(_I32), 0) - 1).to(_I32)
        row = torch.where(win, new_row, row)
        wpos = pos[win]
        htab_key[wpos] = ukeys[win]
        htab_row[wpos] = new_row[win]
        resolved = resolved | win
        is_new = is_new | win
        # Unresolved keys saw either a foreign key or lost a claim: advance.
        probe = torch.where(resolved, probe, probe + 1)
        n_rows = (n_rows + win.sum()).to(_I32)
    ok = resolved.all()
    return htab_key, htab_row, n_rows, row, is_new, ok, rounds


def claim_rows_ref(htab_key, htab_row, n_rows, keys):
    """Plain version of ``claim_rows``."""
    ukeys, inv = unique_padded(keys)
    *out, rounds = find_or_insert_rows_ref(htab_key, htab_row, n_rows, ukeys)
    return (ukeys, inv, *out,
            torch.tensor(rounds, dtype=_I32, device=keys.device))


_PROTOTYPES = {
    "hash_claim_launch": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 2 + [
        ctypes.c_longlong, ctypes.c_void_p]}
#: The kernel's grid cap (``kMaxGrid`` of ``csrc/hash_claim.cu``): its
#: scratch holds one word a slot, three a key, one a block and two flags.
_MAX_GRID = 2048


def claim_rows_cuda(htab_key, htab_row, n_rows, keys):
    """Sort the keys, then launch ``csrc/hash_claim.cu`` on the current
    stream, once: every output stays on the card."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError("claim_rows_cuda needs CUDA tensors")
    for name, t in (("htab_key", htab_key), ("htab_row", htab_row),
                    ("keys", keys)):
        _build.check_vector(t, name, _I32, dev)
    if htab_row.shape != htab_key.shape:
        raise ValueError("htab_key and htab_row must have one entry a slot")
    if n_rows.dim() != 0 or n_rows.dtype != _I32 or n_rows.device != dev:
        raise ValueError("n_rows must be a 0-d int32 on the keys' device")
    hcap, u = htab_key.shape[0], keys.shape[0]
    if not 0 < hcap < 1 << 31 or u >= 1 << 30:
        raise ValueError("the table needs 1 to 2**31 - 1 slots, and the "
                         "keys must number fewer than 2**30")
    s, perm = torch.sort(keys)
    ukeys = torch.empty_like(keys)
    inv = torch.empty_like(perm)
    key_out = torch.empty_like(htab_key)
    row_out = torch.empty_like(htab_row)
    n_out = torch.empty_like(n_rows)
    row = torch.empty_like(keys)
    is_new = torch.empty(u, dtype=torch.bool, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    rounds = torch.empty_like(n_rows)
    scratch = torch.empty(hcap + 3 * u + _MAX_GRID + 2, dtype=_I32,
                          device=dev)
    fn = _build.bind("hash_claim", _PROTOTYPES)["hash_claim_launch"]
    rc = _build.run_on(dev, fn, s.data_ptr(), perm.data_ptr(),
                       ukeys.data_ptr(), inv.data_ptr(), htab_key.data_ptr(),
                       htab_row.data_ptr(), n_rows.data_ptr(),
                       key_out.data_ptr(), row_out.data_ptr(),
                       n_out.data_ptr(), row.data_ptr(), is_new.data_ptr(),
                       ok.data_ptr(), rounds.data_ptr(), scratch.data_ptr(),
                       u, hcap, scratch.numel())
    _build.check(rc, "hash_claim")
    _build.count_launch(claim_rows_cuda)
    return ukeys, inv, key_out, row_out, n_out, row, is_new, ok, rounds


claim_rows_cuda.launches = 0


def claim_rows(htab_key, htab_row, n_rows, keys):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if keys.is_cuda:
        return claim_rows_cuda(htab_key, htab_row, n_rows, keys)
    return claim_rows_ref(htab_key, htab_row, n_rows, keys)
