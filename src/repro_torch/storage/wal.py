"""Append-only write-ahead log with group-commit fsync batching (a copy of
``repro.storage.wal``; its metrics go to the port's registry).

``LSMGraph._apply`` appends every edge batch here *before* it enters
MemGraph.  Appends are buffered ``os.write``s (visible to a reopen even
without fsync); durability against power loss comes from the fsync policy:

  * ``"always"`` — fsync after every append (slowest, strongest);
  * ``"batch"``  — group commit: a background thread fsyncs the active file
    at most every ``sync_interval`` seconds while dirty, so ingest stays off
    the fsync critical path (the paper's async-flush spirit);
  * ``"off"``    — never fsync (tests / benchmarks).

Files rotate at every MemGraph flush so one WAL file covers exactly one
MemGraph generation; ``prune(floor_ts)`` deletes closed files whose records
are all durably represented by flushed segments (``ts < floor_ts``).
"""
from __future__ import annotations

import os
import struct
import threading
import time
import zlib
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np

from .. import obs
from . import faultfs
from .errors import DurabilityLost
from .fsutil import fsync_dir

# WAL instruments (module-level: WALs are per-store but short-lived across
# reopens; per-instance labels would grow unbounded over restarts).
_OBS_APPEND = obs.histogram("storage_wal_append_seconds")
_OBS_FSYNC = obs.histogram("storage_wal_fsync_seconds")
# Group-commit batch size: appends covered per fsync (lo=1: a size, not a
# latency).
_OBS_BATCH = obs.REGISTRY.histogram(
    "storage_wal_group_commit_batch", lo=1.0, hi=1e6)


class WalAppend(NamedTuple):
    """Receipt for one WAL append: a monotonically increasing per-log commit
    sequence number (the group-commit ack token — ``sync_upto(seq)`` awaits
    durability of exactly this record and everything before it) plus the
    record's encoded size for byte accounting."""

    seq: int
    nbytes: int

_MAGIC = 0x314C4157  # "WAL1" little-endian
_HDR = struct.Struct("<IIIB3x")  # magic, payload crc32, payload len, rtype
REC_EDGES = 1
REC_ABORT = 2  # cancels the immediately preceding edge record (insert failed
# after its WAL append — e.g. MemGraph capacity overflow raised to the caller)

_FILE_FMT = "wal-%08d.log"


def _wal_path(wal_dir: str, seq: int) -> str:
    return os.path.join(wal_dir, _FILE_FMT % seq)


def encode_edges(src: np.ndarray, dst: np.ndarray, ts: np.ndarray,
                 marker: np.ndarray, prop: np.ndarray) -> bytes:
    """Serialize one edge batch to a framed WAL record."""
    n = len(src)
    payload = b"".join((
        struct.pack("<I", n),
        np.asarray(src, "<i4").tobytes(),
        np.asarray(dst, "<i4").tobytes(),
        np.asarray(ts, "<i4").tobytes(),
        np.asarray(marker, np.bool_).astype("<u1").tobytes(),
        np.asarray(prop, "<f4").tobytes(),
    ))
    hdr = _HDR.pack(_MAGIC, zlib.crc32(payload), len(payload), REC_EDGES)
    return hdr + payload


def _decode_edges(payload: bytes):
    (n,) = struct.unpack_from("<I", payload, 0)
    need = 4 + n * (4 * 4 + 1)
    if len(payload) != need:
        raise ValueError("WAL edge record length mismatch")
    off = 4
    src = np.frombuffer(payload, "<i4", n, off); off += 4 * n
    dst = np.frombuffer(payload, "<i4", n, off); off += 4 * n
    ts = np.frombuffer(payload, "<i4", n, off); off += 4 * n
    marker = np.frombuffer(payload, "<u1", n, off).astype(bool); off += n
    prop = np.frombuffer(payload, "<f4", n, off)
    return src, dst, ts, marker, prop


def _iter_raw(path: str):
    """Yield (rtype, payload bytes) per valid record; stop cleanly at the
    first torn/corrupt record (a crash mid-append)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return
    off = 0
    while off + _HDR.size <= len(data):
        magic, crc, length, rtype = _HDR.unpack_from(data, off)
        if magic != _MAGIC:
            return
        body = data[off + _HDR.size: off + _HDR.size + length]
        if len(body) != length or zlib.crc32(body) != crc:
            return  # torn tail
        off += _HDR.size + length
        yield rtype, body


def iter_file_records(path: str) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield (src, dst, ts, marker, prop) per valid edge record, honouring
    abort records (an abort drops the preceding edge record)."""
    prev = None
    for rtype, body in _iter_raw(path):
        if rtype == REC_EDGES:
            if prev is not None:
                yield prev
            prev = _decode_edges(body)
        elif rtype == REC_ABORT:
            (ts_start,) = struct.unpack("<q", body)
            if prev is not None and len(prev[2]) and \
                    int(prev[2][0]) == ts_start:
                prev = None
        # unknown record types are skipped (forward compatibility)
    if prev is not None:
        yield prev


def scan_wal_dir(wal_dir: str):
    """Scan every WAL file in seq order.

    Returns ``(records, last_ts_by_seq, max_seq)`` where records is a list of
    ``(seq, src, dst, ts, marker, prop)`` tuples in append order."""
    if not os.path.isdir(wal_dir):
        return [], {}, -1
    seqs: List[int] = []
    for name in os.listdir(wal_dir):
        if name.startswith("wal-") and name.endswith(".log"):
            try:
                seqs.append(int(name[4:-4]))
            except ValueError:
                continue
    seqs.sort()
    records = []
    last_ts: Dict[int, int] = {}
    for seq in seqs:
        last_ts[seq] = -1
        for (src, dst, ts, marker, prop) in iter_file_records(
                _wal_path(wal_dir, seq)):
            if len(ts):
                last_ts[seq] = max(last_ts[seq], int(ts[-1]))
            records.append((seq, src, dst, ts, marker, prop))
    return records, last_ts, (seqs[-1] if seqs else -1)


class WriteAheadLog:
    """Rotating append-only WAL over ``<dir>/wal-<seq>.log`` files."""

    def __init__(self, wal_dir: str, *, sync: str = "batch",
                 sync_interval: float = 0.05, start_seq: int = 0,
                 last_ts_by_seq: Optional[Dict[int, int]] = None):
        assert sync in ("always", "batch", "off")
        self.dir = wal_dir
        self.sync_mode = sync
        self.sync_interval = sync_interval
        os.makedirs(wal_dir, exist_ok=True)
        self._io_lock = threading.Lock()
        self._sync_gate = threading.Lock()  # serializes fsyncs (barrier)
        self._sync_failed = False  # sticky: a failed fsync latches fail-stop
        self._seq = start_seq
        self._last_ts: Dict[int, int] = dict(last_ts_by_seq or {})
        self._last_ts.setdefault(self._seq, -1)
        # Commit sequence numbers: every append gets the next seq;
        # ``_durable_seq`` trails it and advances when an fsync covering
        # that append completes.  Seqs are based at ``start_seq << 32`` so
        # each reopen's range is disjoint from every earlier incarnation's
        # — a receipt held across a crash/reopen can never alias a new
        # batch's seq (``sync_upto`` rejects anything below the base).
        self._seq_base = start_seq << 32
        self._next_commit_seq = self._seq_base
        self._appended_seq = self._seq_base - 1
        self._durable_seq = self._seq_base - 1
        self._path = _wal_path(wal_dir, self._seq)
        self._fd = os.open(self._path,
                           os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        if sync != "off":
            fsync_dir(wal_dir)  # durable directory entry for the new file
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._syncer: Optional[threading.Thread] = None
        if sync == "batch":
            self._syncer = threading.Thread(
                target=self._sync_loop, daemon=True, name="wal-fsync")
            self._syncer.start()

    # ------------------------------------------------------------------ write
    def _append_record(self, rec: bytes,
                       last_ts: Optional[int] = None) -> WalAppend:
        """Shared framed-append core: seq allocation, fail-stop check, and
        the per-policy fsync — one implementation for every record type so
        the commit-seq / fsyncgate protocol cannot desynchronize."""
        t0 = time.perf_counter()
        with self._io_lock:
            self._check_failed()
            try:
                faultfs.write(self._fd, rec, self._path)
            except OSError:
                # A torn append leaves garbage at the tail; replay stops at
                # the first torn record, so any LATER append would be
                # silently dropped even if durably written and acked.
                # Latch fail-stop — same sticky semantics as a failed fsync.
                self._sync_failed = True
                raise
            seq = self._next_commit_seq
            self._next_commit_seq += 1
            self._appended_seq = seq
            if last_ts is not None:
                self._last_ts[self._seq] = last_ts
            if self.sync_mode == "always":
                self._fsync_latched(self._fd)
                self._durable_seq = seq
                _OBS_BATCH.observe(1)
            elif self.sync_mode == "batch":
                self._dirty.set()
        _OBS_APPEND.observe(time.perf_counter() - t0)
        return WalAppend(seq, len(rec))

    def append_edges(self, src, dst, ts, marker, prop) -> WalAppend:
        """Append one edge-batch record; returns a ``WalAppend`` receipt with
        the record's monotonically increasing commit seq (awaitable via
        ``sync_upto``) and its encoded size.  Caller (the store) serializes
        appends; fsync happens per the sync policy."""
        rec = encode_edges(src, dst, ts, marker, prop)
        return self._append_record(
            rec, last_ts=int(ts[-1]) if len(ts) else None)

    def append_abort(self, ts_start: int) -> WalAppend:
        """Log that the preceding edge record's insert FAILED after its WAL
        append (the caller saw an exception): replay must not resurrect it."""
        payload = struct.pack("<q", ts_start)
        rec = _HDR.pack(_MAGIC, zlib.crc32(payload), len(payload),
                        REC_ABORT) + payload
        return self._append_record(rec)

    def sync(self) -> None:
        """Durability barrier.  The fsync runs on a dup'd fd OUTSIDE the
        append lock, so concurrent appends never stall behind the group
        commit (they only race to set the dirty flag again).  A clean log is
        a no-op — but only after passing the gate, which drains any fsync
        still in flight (the barrier must not return before it completes)."""
        if self.sync_mode == "off":
            return
        with self._sync_gate:
            with self._io_lock:
                self._check_failed()
                if self._fd < 0 or not self._dirty.is_set():
                    return
                fd = os.dup(self._fd)
                path = self._path
                upto = self._appended_seq  # every seq <= upto is in the file
                batch = upto - self._durable_seq  # appends this commit covers
                self._dirty.clear()
            t0 = time.perf_counter()
            try:
                faultfs.fsync(fd, path)
            except OSError:
                # fsyncgate: the kernel may mark pages clean after a FAILED
                # fsync, so retrying cannot restore durability.  Latch a
                # sticky fail-stop — every later append/sync raises instead
                # of silently claiming durability that was never achieved.
                with self._io_lock:
                    self._sync_failed = True
                    self._dirty.set()
                raise
            finally:
                os.close(fd)
            _OBS_FSYNC.observe(time.perf_counter() - t0)
            if batch > 0:
                _OBS_BATCH.observe(batch)
            with self._io_lock:
                self._durable_seq = max(self._durable_seq, upto)

    def sync_upto(self, seq: int) -> None:
        """Await durability of commit seq ``seq`` and everything before it —
        the per-batch ack primitive.  Returns
        immediately if a group commit already covered ``seq``; otherwise
        joins (or triggers) one fsync instead of a global barrier.  A no-op
        under the ``"off"`` policy (no durability promised)."""
        if self.sync_mode == "off" or seq < 0:
            return
        while True:
            with self._io_lock:
                if seq < self._seq_base or seq > self._appended_seq:
                    # Outside this incarnation's appended range: a receipt
                    # held across a reopen (below the base) or a seq this
                    # log never issued.  Waiting would either ack the WRONG
                    # batch or spin forever — refuse instead.
                    raise ValueError(
                        f"commit seq {seq} was not appended by this log "
                        f"incarnation (range [{self._seq_base}, "
                        f"{self._appended_seq}]; stale receipt from a "
                        "previous open?)")
                if self._durable_seq >= seq:
                    return
                self._check_failed()
                if self._fd < 0:
                    raise OSError(
                        f"WAL closed before commit seq {seq} became durable")
            # No busy-spin: sync() acquires _sync_gate BEFORE its dirty
            # check, and the background group commit holds that gate for
            # the whole os.fsync — so this call blocks until any in-flight
            # fsync (which may already cover our seq) completes, then
            # fsyncs itself only if appends landed after it.  One group
            # commit after our append necessarily covers our seq.
            self.sync()

    def _fsync_latched(self, fd: int) -> None:
        """fsync under the io lock, latching the fail-stop flag on error
        (the inline-fsync twin of sync()'s fsyncgate handling)."""
        try:
            faultfs.fsync(fd, self._path)
        except OSError:
            self._sync_failed = True
            raise

    def _check_failed(self) -> None:
        if self._sync_failed:
            raise DurabilityLost(
                "WAL fsync previously failed: log durability is unknown "
                "(fail-stop; reopen the store to recover from disk state)")

    def rotate(self) -> int:
        """Fsync + close the active file and start ``wal-<seq+1>.log``.
        Called at MemGraph flush rotation; returns the new seq.

        Takes ``_sync_gate`` first (same order as ``sync()``): an in-flight
        group commit whose fsync FAILS latches the fail-stop under the gate,
        and rotating must observe that latch — a retried fsync on the same
        file description reports success for pages the kernel already
        dropped, so advancing the durable seq here without the gate would
        falsely ack lost records."""
        with self._sync_gate, self._io_lock:
            if self.sync_mode != "off":
                self._check_failed()
                self._fsync_latched(self._fd)
                self._durable_seq = self._appended_seq
                self._dirty.clear()
            os.close(self._fd)
            self._seq += 1
            self._last_ts[self._seq] = -1
            self._path = _wal_path(self.dir, self._seq)
            self._fd = os.open(self._path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            if self.sync_mode != "off":
                fsync_dir(self.dir)
            obs.REGISTRY.trace_instant("storage_wal_rotate",
                                       seq=str(self._seq))
            return self._seq

    def prune(self, floor_ts: int, retain: int = 0) -> int:
        """Delete closed WAL files whose every record has ts < floor_ts
        (they are durably represented by flushed segments).  ``retain``
        keeps the newest N otherwise-prunable files on disk anyway — they
        are the rebuild source for a recently-flushed L0 segment that later
        fails its CRC (see scrub.rebuild_from_wal).  Returns the number of
        files removed."""
        removed = 0
        with self._io_lock:
            prunable = [seq for seq in sorted(self._last_ts)
                        if seq != self._seq and self._last_ts[seq] < floor_ts]
            victims = prunable[:-retain] if retain > 0 else prunable
            for seq in victims:
                try:
                    os.unlink(_wal_path(self.dir, seq))
                except FileNotFoundError:
                    pass
                del self._last_ts[seq]
                removed += 1
            if removed and self.sync_mode != "off":
                fsync_dir(self.dir)
        return removed

    # ------------------------------------------------------------- background
    def _sync_loop(self) -> None:
        while not self._stop.is_set():
            self._dirty.wait(timeout=0.2)
            if self._dirty.is_set():
                try:
                    self.sync()
                except OSError:
                    pass  # fd closed during shutdown race
            self._stop.wait(timeout=self.sync_interval)

    def close(self) -> None:
        self._stop.set()
        if self._syncer is not None:
            self._syncer.join(timeout=2)
        # Gate first (sync()'s order): serialize with an in-flight group
        # commit so its failure latch is observed before we claim the tail
        # durable (see rotate()).
        with self._sync_gate, self._io_lock:
            if self._fd >= 0:
                if self.sync_mode != "off":
                    try:
                        # A latched fsync failure means durability is
                        # unknown: close best-effort, but never claim the
                        # tail durable (sync_upto must keep failing).
                        if not self._sync_failed:
                            faultfs.fsync(self._fd, self._path)
                            self._durable_seq = self._appended_seq
                    except OSError:
                        self._sync_failed = True
                os.close(self._fd)
                self._fd = -1
