"""Last-writer-wins CSR of an update stream, in plain torch.

For each (src, dst) pair the record latest in stream order decides: the
edge is live if that record is an insert, and it carries that insert's
prop.  The result is sorted by (src, dst): ``voff`` int64[n + 1], ``dst``
int32[E], ``prop``[E] in the dtype asked for.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def lww_csr(src: torch.Tensor, dst: torch.Tensor, ins: torch.Tensor,
            prop: torch.Tensor, n: int, prop_dtype=torch.float32
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    key = (src.long() << 32) | dst.long()
    sk, order = torch.sort(key, stable=True)
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[:-1] != sk[1:]
    # A stable sort keeps stream order inside a key: its last record is
    # the latest.
    pick = order[last]
    live = pick[ins[pick]]
    s = src[live].long()
    voff = torch.searchsorted(s, torch.arange(n + 1, device=s.device))
    return voff, dst[live].to(torch.int32), prop[live].to(prop_dtype)


def adjacency_of(csr, vertices: np.ndarray):
    """(offsets int64[len + 1], dst int32, prop) on the host: the
    adjacency lists of ``vertices``, in that order, laid end to end."""
    voff, dst, prop = csr
    v = torch.as_tensor(np.asarray(vertices, np.int64), device=voff.device)
    lo, hi = voff[v], voff[v + 1]
    deg = hi - lo
    offs = torch.zeros(len(v) + 1, dtype=torch.int64, device=voff.device)
    offs[1:] = torch.cumsum(deg, 0)
    total = int(offs[-1])
    edge = torch.arange(total, device=voff.device)
    owner = torch.searchsorted(offs[1:], edge, right=True)
    at = lo[owner] + (edge - offs[owner])
    return (offs.cpu().numpy(), dst[at].cpu().numpy(), prop[at].cpu().numpy())
