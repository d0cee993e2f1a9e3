"""Shared bits for the competitor-system emulations (numpy-based).

The benchmark's primary cross-system metric is BYTES MOVED (the disk-I/O
proxy, Figs 12/13) plus wall time; byte accounting uses the same 16+4 B/edge
convention as the LSMGraph store (core/types.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.types import BYTES_PER_EDGE, BYTES_PER_PROP

REC_BYTES = BYTES_PER_EDGE + BYTES_PER_PROP
BLOCK_BYTES = 4096  # charged granularity of a random read (SSD block)


@dataclasses.dataclass
class IO:
    write: int = 0
    read: int = 0

    def snapshot(self):
        return dataclasses.replace(self)


def dedup_last(src, dst, ts, marker, prop):
    """Keep the newest record per (src, dst); drop tombstoned keys."""
    order = np.lexsort((ts, dst, src))
    src, dst, ts, marker, prop = (a[order] for a in (src, dst, ts, marker,
                                                     prop))
    last = np.ones(len(src), bool)
    if len(src):
        last[:-1] = (src[:-1] != src[1:]) | (dst[:-1] != dst[1:])
    live = last & ~marker
    return src[live], dst[live], prop[live]


def to_csr(src, dst, prop, n_vertices: int):
    voff = np.searchsorted(src, np.arange(n_vertices + 1)).astype(np.int32)
    return voff, dst.astype(np.int32), prop.astype(np.float32)
