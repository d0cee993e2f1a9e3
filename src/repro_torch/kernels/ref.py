"""Pure numpy/Python oracle for the merge kernel (test reference).

A copy of ``repro.kernels.ref.merge_perm_ref``: a Python sort of the tagged
records, slow and obviously right.
"""
from __future__ import annotations

import numpy as np


def merge_perm_ref(a_keys, b_keys, na: int, nb: int) -> np.ndarray:
    """Permutation merging two (k1,k2,k3)-lexicographically-sorted key sets.

    Returns perm int32[len] with values indexing concat(A, B); A wins ties
    (stability).  Padded tail (beyond na+nb) points at INVALID (= total)."""
    a_keys = [np.asarray(k) for k in a_keys]
    b_keys = [np.asarray(k) for k in b_keys]
    a1, a2, a3 = (k[:na] for k in a_keys)
    b1, b2, b3 = (k[:nb] for k in b_keys)
    acap = len(a_keys[0])
    cap = acap + len(b_keys[0])
    keys = list(zip(a1.tolist(), a2.tolist(), a3.tolist(), [0] * na,
                    range(na))) + \
        list(zip(b1.tolist(), b2.tolist(), b3.tolist(), [1] * nb,
                 [acap + j for j in range(nb)]))
    keys.sort(key=lambda t: (t[0], t[1], t[2], t[3]))
    perm = np.full(cap, cap, np.int32)
    for out_i, t in enumerate(keys):
        perm[out_i] = t[4]
    return perm
