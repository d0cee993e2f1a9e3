"""Typed error taxonomy for the durable storage engine.

The storage layer used to surface every failure as a bare ``OSError`` /
``ValueError``; callers (the sharded service, the chaos harness, retry
loops) could not tell a retryable EIO from a corrupt segment from a lost
durability guarantee.  The taxonomy:

* ``StorageError``     — common base; ``isinstance(e, StorageError)`` is the
  "storage subsystem failed (typed)" check the shard fencing layer keys on.
* ``TransientIOError`` — the medium hiccuped (EIO on a read, mmap fault).
  Retryable with bounded exponential backoff; ``transient = True`` is the
  duck-typed marker the core retry loops check (core must not import this
  package — it would cycle through ``storage/__init__`` -> ``engine`` ->
  ``core.store``).
* ``CorruptionError``  — the bytes are wrong (CRC mismatch, bad magic,
  truncation, header/manifest disagreement, missing live file).  NEVER
  retryable: re-reading rot yields rot.  Subclasses ``ValueError`` so
  pre-taxonomy callers (and tests) that caught ``ValueError`` keep working.
* ``DurabilityLost``   — an fsync (or WAL append) failed, so durability of
  already-acknowledged-to-the-caller state is unknown (fsyncgate).  NEVER
  retryable — the kernel may have marked dirty pages clean, so a retried
  fsync reports success for data that is gone.  Subclasses ``OSError`` for
  the same compatibility reason.

``retry_transient`` is the shared bounded-backoff helper for read-path I/O.
Write-path failures are deliberately NOT retried anywhere: the WAL latches
fail-stop instead (see ``wal.py``).
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Tuple, TypeVar


class StorageError(Exception):
    """Base of every typed storage failure."""

    transient = False


class TransientIOError(StorageError, OSError):
    """A retryable I/O failure on the read path (EIO, mmap fault, ...)."""

    transient = True


class CorruptionError(StorageError, ValueError):
    """On-disk bytes failed an integrity check (CRC, magic, truncation,
    metadata disagreement).  Carries the affected segment ``fid`` and the
    ``ranges`` of vertex ids whose data is unavailable, when known."""

    transient = False

    def __init__(self, msg: str, *, fid: Optional[int] = None,
                 ranges: Tuple["DegradedRange", ...] = ()):
        super().__init__(msg)
        self.fid = fid
        self.ranges = tuple(ranges)


class DurabilityLost(StorageError, OSError):
    """Durability of previously-written state is unknown (failed fsync or
    torn WAL append latched fail-stop).  ``shard`` names the failing shard
    when raised through the sharded service."""

    transient = False

    def __init__(self, msg: str = "", *, shard: Optional[int] = None):
        super().__init__(msg)
        self.shard = shard


class DegradedRange(NamedTuple):
    """A vertex-id range whose on-disk data is quarantined/unreadable."""

    lo: int        # min vertex id (inclusive)
    hi: int        # max vertex id (inclusive)
    fid: int       # segment file id that carried the range
    reason: str


class RetryPolicy(NamedTuple):
    """Bounded exponential backoff + wall-clock deadline for transient
    read-path I/O.  Defaults keep worst-case added latency ~10 ms."""

    attempts: int = 3          # total tries (1 initial + attempts-1 retries)
    base_delay: float = 0.002  # seconds before the first retry
    max_delay: float = 0.1     # backoff cap
    deadline: float = 2.0      # wall-clock budget across all retries


DEFAULT_RETRY = RetryPolicy()

T = TypeVar("T")


def retry_transient(fn: Callable[[], T],
                    policy: RetryPolicy = DEFAULT_RETRY,
                    on_retry: Optional[Callable[[BaseException], None]] = None
                    ) -> T:
    """Call ``fn``, retrying failures whose ``transient`` attribute is true
    with bounded exponential backoff.  Non-transient errors, exhausted
    attempts, and a blown deadline all propagate the last error."""
    deadline = time.monotonic() + policy.deadline
    delay = policy.base_delay
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            attempt += 1
            if (not getattr(e, "transient", False)
                    or attempt >= policy.attempts
                    or time.monotonic() + delay > deadline):
                raise
            if on_retry is not None:
                on_retry(e)
            time.sleep(delay)
            delay = min(delay * 2, policy.max_delay)


__all__ = [
    "StorageError", "TransientIOError", "CorruptionError", "DurabilityLost",
    "DegradedRange", "RetryPolicy", "DEFAULT_RETRY", "retry_transient",
]
