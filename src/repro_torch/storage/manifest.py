"""Versioned manifest: the LSM membership edit-log (LevelDB-style VERSION
edits, JSON-lines flavor).

One record is appended — and fsync'd — at every publish (store creation,
MemGraph flush, compaction commit).  A record is a single ``write`` of one
line, so a crash leaves either the whole edit or a torn last line, which
replay drops: flush and compaction commits are crash-atomic.  See the
package docstring for the record schema.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from typing import Dict, List, Optional

from . import faultfs
from .errors import DurabilityLost
from .fsutil import fsync_dir

MANIFEST_NAME = "MANIFEST.log"
FORMAT_VERSION = 1


@dataclasses.dataclass
class ManifestState:
    """Folded result of replaying the edit log."""

    segments: Dict[int, dict] = dataclasses.field(default_factory=dict)
    quarantined: Dict[int, dict] = dataclasses.field(default_factory=dict)
    tau: int = 0
    wal_floor: int = 0
    next_fid: int = 0
    config: Optional[dict] = None
    n_records: int = 0

    def apply(self, rec: dict) -> None:
        op = rec.get("op")
        if op == "open":
            self.config = rec.get("config")
        elif op in ("flush", "compact"):
            for fid in rec.get("remove", ()):
                self.segments.pop(int(fid), None)
            for desc in rec.get("add", ()):
                self.segments[int(desc["fid"])] = desc
            self.tau = max(self.tau, int(rec.get("tau", 0)))
            self.wal_floor = max(self.wal_floor,
                                 int(rec.get("wal_floor", 0)))
            self.next_fid = max(self.next_fid, int(rec.get("next_fid", 0)))
        elif op == "quarantine":
            # A CRC-failed segment left the live set; its bytes (if any)
            # moved under quarantine/.  Kept folded so recovery knows the
            # range is degraded until a later "rebuild" supersedes it.
            fid = int(rec["fid"])
            self.segments.pop(fid, None)
            self.quarantined[fid] = rec
        elif op == "rebuild":
            for desc in rec.get("add", ()):
                fid = int(desc["fid"])
                self.segments[fid] = desc
                self.quarantined.pop(fid, None)
        self.n_records += 1


def _frame(rec: dict) -> bytes:
    body = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    return f"{body} #{zlib.crc32(body.encode()):08x}\n".encode()


def _unframe(line: bytes) -> Optional[dict]:
    try:
        text = line.decode()
        body, _, crc = text.rstrip("\n").rpartition(" #")
        if not body or zlib.crc32(body.encode()) != int(crc, 16):
            return None
        return json.loads(body)
    except (ValueError, UnicodeDecodeError):
        return None


class Manifest:
    """Append-only manifest over ``<root>/MANIFEST.log``."""

    def __init__(self, root: str):
        self.path = os.path.join(root, MANIFEST_NAME)
        existed = os.path.exists(self.path)
        if existed:
            # Drop a crash-torn tail BEFORE appending: records written after
            # a torn line would sit behind it forever (replay stops at the
            # first bad line) — flushed segments would later be GC'd as
            # orphans while their WAL backing is pruned: silent loss.
            self._truncate_to_valid_prefix()
        self._fd = os.open(self.path, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        self._failed = False  # sticky: one failed publish latches fail-stop
        # Publishes used to come only from the (serialized) flush/compact
        # path; quarantine events can now arrive from reader threads too.
        self._append_lock = threading.Lock()
        if not existed:
            fsync_dir(root)  # make the directory entry itself durable

    def _truncate_to_valid_prefix(self) -> None:
        valid = 0
        with open(self.path, "rb") as f:
            for line in f:
                if _unframe(line) is None:
                    break
                valid += len(line)
        if valid < os.path.getsize(self.path):
            with open(self.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())

    def append(self, rec: dict) -> int:
        """Append + fsync one edit record; returns bytes written.  Edits are
        rare (one per flush/compaction) so the fsync is off the ingest path.

        A failed write/fsync latches sticky fail-stop (same fsyncgate logic
        as the WAL): a torn manifest line hides every later record from
        replay, so appending past a failure would publish edits a reopen
        silently drops."""
        data = _frame(rec)
        with self._append_lock:
            if self._failed:
                raise DurabilityLost(
                    "manifest publish previously failed: edit-log durability "
                    "is unknown (fail-stop; reopen the store to recover)")
            try:
                faultfs.write(self._fd, data, self.path)
                faultfs.fsync(self._fd, self.path)
            except OSError as e:
                self._failed = True
                if isinstance(e, DurabilityLost):
                    raise
                raise DurabilityLost(
                    f"manifest publish failed: {e}") from e
        return len(data)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    # ------------------------------------------------------------------ read
    @staticmethod
    def exists(root: str) -> bool:
        return os.path.exists(os.path.join(root, MANIFEST_NAME))

    @staticmethod
    def replay(root: str) -> List[dict]:
        """All valid records in order; stops at the first torn/corrupt line
        (only ever the crash-torn tail)."""
        path = os.path.join(root, MANIFEST_NAME)
        records: List[dict] = []
        try:
            with open(path, "rb") as f:
                for line in f:
                    rec = _unframe(line)
                    if rec is None:
                        break
                    records.append(rec)
        except FileNotFoundError:
            pass
        return records

    @staticmethod
    def load_state(root: str) -> ManifestState:
        st = ManifestState()
        for rec in Manifest.replay(root):
            st.apply(rec)
        return st
