"""The card's peaks and the bytes a kernel needs: what a roofline share is
measured against.

Peak: NVIDIA H100 SXM data sheet, 3.35 TB/s of HBM3 at the full 700 W
power limit; a card set below it reads lower shares, so every share is
reported with the card's power limit beside it.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def segment_reduce_bytes(n_edges: int, n_vertices: int) -> int:
    """Least bytes one call of ``gather_segsum`` or ``gather_segmin`` over
    a CSR view moves: ``dst``, ``seg_id`` and ``wt`` (4 bytes each) read
    once an edge, ``x`` read once and ``y`` written once (4 bytes each) a
    vertex."""
    return 12 * int(n_edges) + 8 * int(n_vertices)


def bound_seconds(nbytes: float) -> float:
    """Least time the card takes to move ``nbytes`` through HBM."""
    return nbytes / HBM_BYTES_PER_S
