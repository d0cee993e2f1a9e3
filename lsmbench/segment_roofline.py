"""A segment kernel's share of its roofline, from the device trace: the
least time its launches could take (``roofline.segment_reduce_bytes`` of
the view they ran on, over HBM's rate) over the device time they took.

A call of ``gather_segsum`` or ``gather_segmin`` is two launches, a fill
of ``y`` and then the reduction; both count.  The trace names the
reduction ``seg_reduce_kernel<...SumOp>`` or ``<...MinOp>`` and the fill
``fill_kernel``, which runs right before it on the same stream.
"""
from __future__ import annotations

from typing import Optional

from .roofline import bound_seconds, segment_reduce_bytes

FILL = "fill_kernel"
REDUCE = "seg_reduce_kernel"


def share(run, op: str) -> Optional[float]:
    p, view = run.profile, run.info.get("segment_view")
    if p is None or view is None:
        return None
    calls, device_s, fill = 0, 0.0, 0.0
    for lo, hi, name in p["device"]:
        if FILL in name:
            fill = hi - lo
        elif REDUCE in name and op in name:
            calls += 1
            device_s += fill + (hi - lo)
            fill = 0.0
        else:
            fill = 0.0
    if not calls:
        return None
    return 100.0 * calls * bound_seconds(segment_reduce_bytes(*view)) / \
        device_s
