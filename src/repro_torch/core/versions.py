"""Vertex-grained version control (paper §4.3).

The version chain covers only {MemGraph, L0} membership — L1+ visibility is
carried per-vertex by the multi-level index (min-readable-fid + level slots),
exactly the paper's split.  Readers pin a version (refcount); unpinned,
non-current versions are pruned and their runs become collectable.

Snapshot isolation: a reader acquires τ = current timestamp and only sees
edge records with ts <= τ; records with a delete marker annihilate older
records of the same (src, dst).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from .types import Version


class VersionChain:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._versions: Dict[int, Version] = {}
        self._refcount: Dict[int, int] = {}
        self._reader_taus: List[int] = []  # multiset of pinned readers' τ
        self._next_vid = 0
        self._current: Optional[int] = None

    def publish(self, memgraph_ids: Tuple[int, ...], l0_fids: Tuple[int, ...],
                tau: int) -> Version:
        """Install a new current version (copy-of-curr semantics live in the
        caller, which passes the full membership)."""
        with self._lock:
            vid = self._next_vid
            self._next_vid += 1
            v = Version(vid=vid, memgraph_ids=tuple(memgraph_ids),
                        l0_fids=tuple(l0_fids), tau=tau)
            self._versions[vid] = v
            self._refcount[vid] = 0
            old = self._current
            self._current = vid
            if old is not None:
                self._gc_locked(old)
            return v

    def pin(self, version: Version, reader_tau: int) -> Version:
        """Pin a version a reader obtained from a published ``StoreState``
        (the paper's 'acquire the latest snapshot number before reading').

        Lock-free callers read ``store._state`` *without* holding this lock,
        so by the time they pin, ``publish`` may already have GC'd the
        version (it had no pins and a newer current).  Re-inserting it here
        (resurrection) is safe: the caller holds a strong reference to the
        frozen ``StoreState``, so every run/memgraph the version names is
        still reachable; the refcount entry merely re-registers it with the
        GC so ``min_live_tau`` and ``live_versions`` account for the reader.
        """
        with self._lock:
            self._versions.setdefault(version.vid, version)
            self._refcount[version.vid] = self._refcount.get(version.vid, 0) + 1
            self._reader_taus.append(reader_tau)
            return version

    def unpin(self, vid: int, reader_tau: int) -> None:
        with self._lock:
            self._refcount[vid] -= 1
            self._reader_taus.remove(reader_tau)
            self._gc_locked(vid)

    def _gc_locked(self, vid: int) -> None:
        if vid != self._current and self._refcount.get(vid, 0) <= 0:
            self._versions.pop(vid, None)
            self._refcount.pop(vid, None)

    def live_versions(self) -> List[Version]:
        with self._lock:
            return list(self._versions.values())

    def min_live_tau(self, current_tau: int) -> int:
        """Oldest τ any pinned reader may still need — the compaction GC
        horizon.  With no pinned readers this is the current τ."""
        with self._lock:
            taus = list(self._reader_taus)
        return min(taus + [current_tau])

    @property
    def current_vid(self) -> Optional[int]:
        return self._current
