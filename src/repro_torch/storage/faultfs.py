"""Deterministic fault-injection seam for the durability modules.

Every instrumented I/O site (WAL/segment/manifest fsyncs and writes,
segment reads) calls through this module instead of ``os.*`` directly.
With no plan installed the hooks are a single ``is None`` check plus the
real syscall — zero-cost when disarmed, which is the production state.

A ``FaultPlan`` is a process-global list of ``FaultRule``s.  Each rule
targets one op kind and fires on the Nth matching call:

* ``"fsync"``   — the fsync is NOT performed; ``OSError(EIO)`` is raised.
  Downstream this exercises the fsyncgate fail-stop latch.
* ``"write"``   — only ``tear_at`` bytes of the buffer are written before
  ``OSError(EIO)`` — a torn append.  ``tear_at=0`` writes nothing.
* ``"read"``    — ``OSError(EIO)`` before the file is opened — a transient
  medium error the retry path must absorb.
* ``"bitflip"`` — one bit of the real file is flipped in place before the
  read proceeds, so the *genuine* CRC verification path detects it (no
  simulated corruption error — the real one).

Rules match on a path substring, skip a configurable number of matching
calls, and fire a bounded number of times; every firing is recorded in
``plan.fired_log`` so tests can assert the schedule actually executed.
"""
from __future__ import annotations

import errno
import os
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

_SEG_HEADER_BYTES = 64  # default bit-flip target: first body byte


@dataclass
class FaultRule:
    op: str                       # "fsync" | "write" | "read" | "bitflip"
    match: str = ""               # path substring; "" matches every path
    skip: int = 0                 # matching calls to pass through first
    count: int = 1                # max firings (-1 = unlimited)
    tear_at: int = 0              # "write": bytes written before the error
    offset: Optional[int] = None  # "bitflip": byte offset (default body[0])
    bit: int = 0                  # "bitflip": bit index within that byte
    err: int = errno.EIO
    # runtime counters (owned by the plan lock)
    seen: int = 0
    fired: int = 0

    def _should_fire(self) -> bool:
        self.seen += 1
        if self.seen <= self.skip:
            return False
        if self.count >= 0 and self.fired >= self.count:
            return False
        self.fired += 1
        return True


class FaultPlan:
    """A set of fault rules plus a log of which fired where."""

    def __init__(self, rules: Optional[List[FaultRule]] = None):
        self.rules: List[FaultRule] = list(rules or [])
        self.fired_log: List[Tuple[str, str]] = []  # (op, path)
        self._lock = threading.Lock()

    def add(self, rule: FaultRule) -> "FaultPlan":
        with self._lock:
            self.rules.append(rule)
        return self

    def _pick(self, op: str, path: str) -> Optional[FaultRule]:
        with self._lock:
            for r in self.rules:
                if r.op == op and (not r.match or r.match in path):
                    if r._should_fire():
                        self.fired_log.append((op, path))
                        return r
        return None


_PLAN: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _PLAN
    _PLAN = plan


def clear() -> None:
    global _PLAN
    _PLAN = None


def is_armed() -> bool:
    return _PLAN is not None


class fault_plan:
    """``with fault_plan(plan): ...`` — install for the block, then clear.
    Always clears on exit so a failing test cannot leak faults into the
    next one."""

    def __init__(self, plan: Optional[FaultPlan] = None):
        self.plan = plan if plan is not None else FaultPlan()

    def __enter__(self) -> FaultPlan:
        install(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        clear()


def _err(rule: FaultRule, op: str, path: str) -> OSError:
    return OSError(rule.err, f"injected {op} fault", path or None)


# --------------------------------------------------------------------- hooks
def fsync(fd: int, path: str = "") -> None:
    """``os.fsync`` with injection.  A firing rule SKIPS the real fsync —
    matching the failure being modeled, where the kernel may drop the dirty
    pages the caller believed it persisted."""
    if _PLAN is None:
        os.fsync(fd)
        return
    rule = _PLAN._pick("fsync", path)
    if rule is not None:
        raise _err(rule, "fsync", path)
    os.fsync(fd)


def write(fd: int, data: bytes, path: str = "") -> int:
    """``os.write`` with torn-write injection: a firing rule persists only
    the first ``tear_at`` bytes, then raises."""
    if _PLAN is None:
        return os.write(fd, data)
    rule = _PLAN._pick("write", path)
    if rule is not None:
        tear = max(0, min(rule.tear_at, len(data)))
        if tear:
            os.write(fd, data[:tear])
        raise _err(rule, "write", path)
    return os.write(fd, data)


def check_read(path: str) -> None:
    """Called before a segment/manifest file read.  Injects EIO, or flips a
    bit of the real file in place so the caller's own CRC check trips."""
    if _PLAN is None:
        return
    rule = _PLAN._pick("read", path)
    if rule is not None:
        raise _err(rule, "read", path)
    rule = _PLAN._pick("bitflip", path)
    if rule is not None:
        flip_bit(path, rule.offset, rule.bit)


def flip_bit(path: str, offset: Optional[int] = None, bit: int = 0) -> None:
    """Flip one bit of ``path`` in place (default: the first byte after the
    segment header, i.e. the first body byte)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    off = _SEG_HEADER_BYTES if offset is None else offset
    off = min(max(off, 0), size - 1)
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ (1 << (bit & 7))]))
        f.flush()
        os.fsync(f.fileno())


__all__ = [
    "FaultRule", "FaultPlan", "fault_plan", "install", "clear", "is_armed",
    "fsync", "write", "check_read", "flip_bit",
]
