"""``DurableStorage``: the durability hook object wired into ``LSMGraph``
(the port of ``repro.storage.engine``).  Segment files are written from the
store's device tensors and loaded back onto that device.

The core store stays free of file I/O; when constructed with a
``DurableStorage`` it calls these hooks at the three durability points:

  * ``on_apply``          — WAL append *before* the batch enters MemGraph;
  * ``on_flush_rotate`` / ``on_flush_commit`` — WAL rotation at MemGraph
    double-buffer swap, then segment write + manifest flush-edit + WAL prune
    once the L0 run is built;
  * ``on_compact_segments`` / ``on_compact_commit`` — new segment files are
    written (fsync'd) during the lock-free compute phase; the manifest
    compaction edit lands after the in-memory metadata swap, after which the
    replaced files are deleted.

Crash windows and their recovery outcomes:

  ===============================================  =========================
  crash between                                    recovery outcome
  ===============================================  =========================
  WAL append … segment write                       WAL tail replays the batch
  segment write … manifest flush edit              orphan segment GC'd; WAL
                                                   tail replays the batch
  manifest flush edit … WAL prune                  stale WAL skipped (floor)
  compaction segment writes … manifest edit        orphans GC'd; old segments
                                                   stay live
  manifest compaction edit … old-file delete       dead files GC'd at reopen
  ===============================================  =========================

``open_store`` is the public entry point: create a fresh durable store or
recover an existing directory, on the current CUDA card unless the caller
passes ``device``.
"""
from __future__ import annotations

import dataclasses
import fcntl
import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from .. import obs
from ..core.store import LSMGraph
from ..core.types import RunFile, StoreConfig, resolve_device
from . import scrub as scrub_mod
from . import segments as seg_mod
from .errors import CorruptionError, DegradedRange
from .manifest import Manifest
from .wal import WriteAheadLog

SEGMENT_DIR = "segments"
WAL_DIR = "wal"
QUARANTINE_DIR = scrub_mod.QUARANTINE_DIR

_OBS_SEG_WRITE = obs.histogram("storage_segment_write_seconds")
_OBS_EVICT = obs.counter("storage_segment_evict_total")
_OBS_QUARANTINE = obs.counter("storage_quarantine_total")


class SimulatedCrash(RuntimeError):
    """Raised by test-injected crash points (see ``DurableStorage.crash_at``)."""


def _seg_name(fid: int) -> str:
    return "seg-%08d.csr" % fid


class DurableStorage:
    """Owns the directory, WAL and manifest for one durable ``LSMGraph``."""

    def __init__(self, root: str, *, device=None, wal_sync: str = "batch",
                 wal_sync_interval: float = 0.05, wal_start_seq: int = 0,
                 wal_last_ts: Optional[Dict[int, int]] = None,
                 wal_retain: int = 2, on_corruption: str = "degrade",
                 scrub_interval: Optional[float] = None):
        assert on_corruption in ("degrade", "raise")
        self.root = root
        # Where loaders put segment arrays and WAL rebuilds sort: the
        # store's device (None: the current CUDA card).
        self.device = resolve_device(device)
        self.seg_dir = os.path.join(root, SEGMENT_DIR)
        os.makedirs(self.seg_dir, exist_ok=True)
        # Failure handling: keep the newest ``wal_retain`` prunable WAL
        # generations as the rebuild source for recently-flushed L0
        # segments; ``on_corruption`` picks whether an unrebuildable
        # segment degrades its vertex range ("degrade") or fails the open
        # ("raise"); ``scrub_interval`` (seconds) arms the background
        # CRC scrubber once a store is attached.
        self.wal_retain = wal_retain
        self.on_corruption = on_corruption
        self.scrub_interval = scrub_interval
        self.scrubber: Optional[scrub_mod.Scrubber] = None
        self.degraded: Dict[int, DegradedRange] = {}
        self._deg_lock = threading.Lock()
        self.seg_descs: Dict[int, dict] = {}  # fid -> manifest descriptor
        self._pending_wal_seq = -1  # closed WAL gen of the in-flight flush
        # Exclusive advisory lock (LevelDB-style LOCK file): two writer
        # PROCESSES interleaving manifest/WAL appends would corrupt the
        # store.  POSIX record locks (lockf) are per-process, so reopening
        # after an in-process simulated crash (abandoned handle) still works.
        self._lock_fd = os.open(os.path.join(root, "LOCK"),
                                os.O_WRONLY | os.O_CREAT, 0o644)
        try:
            fcntl.lockf(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except OSError:
            os.close(self._lock_fd)
            raise RuntimeError(
                f"{root} is locked by another process (durable stores are "
                "single-writer; close the other handle first)") from None
        self.wal = WriteAheadLog(
            os.path.join(root, WAL_DIR), sync=wal_sync,
            sync_interval=wal_sync_interval, start_seq=wal_start_seq,
            last_ts_by_seq=wal_last_ts)
        self.manifest = Manifest(root)
        self.store: Optional[LSMGraph] = None
        # Manifest bytes appended before a store is attached (the "open"
        # record lands pre-construction) — credited to io.manifest_write at
        # attach time.
        self._pending_manifest_bytes = 0
        # Test hook: crash point names at which hooks raise SimulatedCrash
        # ("post_wal_append", "pre_manifest_flush", "pre_manifest_compact").
        self.crash_at: Set[str] = set()
        self._closed = False

    def attach(self, store: LSMGraph) -> None:
        self.store = store
        if self._pending_manifest_bytes:
            store.io.manifest_write += self._pending_manifest_bytes
            self._pending_manifest_bytes = 0
        if self.scrub_interval is not None and self.scrubber is None:
            self.scrubber = scrub_mod.Scrubber(self, self.scrub_interval)
            self.scrubber.start()

    def _manifest_append(self, rec: dict) -> int:
        """Single funnel for manifest edits: append + byte accounting (the
        one durable write ``IOCounters`` didn't count)."""
        nbytes = self.manifest.append(rec)
        if self.store is not None:
            self.store.io.manifest_write += nbytes
        else:
            self._pending_manifest_bytes += nbytes
        return nbytes

    def _write_segment_timed(self, path: str, rf: RunFile) -> int:
        t0 = time.perf_counter()
        nbytes = seg_mod.write_segment(path, rf)
        _OBS_SEG_WRITE.observe(time.perf_counter() - t0)
        # Physical per-level write-amp numerator: every segment-file write
        # (flush, compaction output, scrub heal) funnels through here.
        if self.store is not None:
            obs.counter("storage_level_write_bytes",
                        store=self.store.obs_label,
                        level=str(rf.level)).inc(nbytes)
        return nbytes

    def _crashpoint(self, name: str) -> None:
        if name in self.crash_at:
            self.wal.sync()
            raise SimulatedCrash(name)

    def seg_path(self, fid: int) -> str:
        return os.path.join(self.seg_dir, _seg_name(fid))

    def make_loader(self, path: str, desc: Optional[dict] = None):
        """Lazy segment loader bound to ``desc`` (the manifest descriptor)
        for metadata cross-checks.  Retry of transient errors happens in
        ``RunFile.ensure_loaded``; this closure handles the NON-retryable
        outcome — corruption — by failing fast: quarantine + manifest event
        + degraded range, then a typed raise.  No inline repair on the
        serving path (the scrubber / a reopen rebuilds off-path)."""
        def load():
            seg_mod.advise_willneed(path)  # kernel readahead under the load
            try:
                meta, run = seg_mod.read_segment(path, device=self.device)
                if desc is not None:
                    for key in ("fid", "level", "min_vid", "max_vid",
                                "nv", "ne"):
                        if meta[key] != desc[key]:
                            raise CorruptionError(
                                f"{path}: header {key}={meta[key]} disagrees "
                                f"with manifest {desc[key]}", fid=desc["fid"])
            except CorruptionError as e:
                raise self._on_corrupt_load(path, desc, e) from e
            if self.store is not None:
                self.store.io.segment_read += (
                    os.path.getsize(path) if os.path.exists(path) else 0)
            return run
        return load

    def _on_corrupt_load(self, path: str, desc: Optional[dict],
                         err: CorruptionError) -> CorruptionError:
        rng = self.quarantine_segment(path, desc, str(err))
        fid = err.fid if err.fid is not None else (desc or {}).get("fid")
        return CorruptionError(str(err), fid=fid,
                               ranges=(rng,) if rng is not None else ())

    def quarantine_segment(self, path: str, desc: Optional[dict],
                           reason: str) -> Optional[DegradedRange]:
        """Move a corrupt segment under quarantine/, publish the manifest
        event, and record its vertex range as degraded.  Returns the range
        (None when no descriptor names one)."""
        qpath = scrub_mod.quarantine_file(self.root, path)
        if desc is None:
            return None
        rng = DegradedRange(int(desc["min_vid"]), int(desc["max_vid"]),
                            int(desc["fid"]), reason)
        with self._deg_lock:
            self.degraded[rng.fid] = rng
        _OBS_QUARANTINE.inc()
        obs.REGISTRY.trace_instant("storage_quarantine", fid=str(rng.fid),
                                   reason=reason[:80])
        try:
            self._manifest_append({
                "op": "quarantine", "fid": rng.fid, "reason": reason,
                "desc": desc,
                "qfile": os.path.basename(qpath) if qpath else None})
        except OSError:
            # Advisory: with no quarantine record, a reopen re-detects the
            # moved/missing file and converges to the same degraded state.
            pass
        if self.store is not None:
            # Publish a fresh StoreState so snapshots taken from now on see
            # the degraded range (already-pinned snapshots keep serving
            # their frozen state and hit the typed error on lazy reload).
            self.store.note_health_change()
        return rng

    def mark_rebuilt(self, desc: dict) -> None:
        """Publish a successful rebuild: the fid is live again."""
        obs.REGISTRY.trace_instant("storage_rebuild", fid=str(desc["fid"]))
        self._manifest_append({"op": "rebuild", "add": [desc]})
        with self._deg_lock:
            self.degraded.pop(int(desc["fid"]), None)
        if self.store is not None:
            self.store.note_health_change()

    def degraded_ranges(self) -> Tuple[DegradedRange, ...]:
        with self._deg_lock:
            return tuple(sorted(self.degraded.values()))

    def _segdesc(self, rf: RunFile, wal_seq: Optional[int] = None) -> dict:
        desc = {"fid": rf.fid, "level": rf.level, "file": _seg_name(rf.fid),
                "min_vid": rf.min_vid, "max_vid": rf.max_vid,
                "created_ts": rf.created_ts, "nv": rf.nv, "ne": rf.ne}
        if wal_seq is not None and wal_seq >= 0:
            desc["wal_seq"] = wal_seq  # rebuild source (L0 flush only)
        return desc

    # ------------------------------------------------------------ store hooks
    def on_apply(self, src, dst, ts, marker, prop) -> int:
        """WAL-before-MemGraph: called under the store lock, right after ts
        assignment.  A buffered write; fsync follows the group-commit policy.
        Returns the append's commit seq — the ``ack``/``sync_upto`` token."""
        rcpt = self.wal.append_edges(src, dst, ts, marker, prop)
        self.store.io.wal_write += rcpt.nbytes
        self._crashpoint("post_wal_append")
        return rcpt.seq

    def on_apply_abort(self, ts_start: int) -> None:
        """The batch just WAL'd failed its MemGraph insert (exception raised
        to the caller): log an abort so replay doesn't resurrect it."""
        self.store.io.wal_write += self.wal.append_abort(ts_start).nbytes

    def on_flush_rotate(self, boundary_ts: int) -> None:
        """MemGraph double-buffer swap: records with ts >= boundary_ts go to
        a fresh WAL file, so the closed file maps 1:1 to the full MemGraph.
        The closed generation is remembered: it becomes the flush segment's
        ``wal_seq`` rebuild pointer."""
        self._pending_wal_seq = self.wal.rotate() - 1

    def on_flush_commit(self, rf: RunFile, wal_floor: int) -> None:
        """The L0 run is built and published in memory: make it durable."""
        path = self.seg_path(rf.fid)
        nbytes = self._write_segment_timed(path, rf)
        desc = self._segdesc(rf, wal_seq=self._pending_wal_seq)
        rf.path = path
        rf.loader = self.make_loader(path, desc)
        self.seg_descs[rf.fid] = desc
        self.store.io.segment_write += nbytes
        self._crashpoint("pre_manifest_flush")
        self._manifest_append({
            "op": "flush", "tau": wal_floor, "wal_floor": wal_floor,
            "next_fid": self.store._next_fid, "add": [desc],
        })
        self.wal.prune(wal_floor, retain=self.wal_retain)

    def on_compact_segments(self, new_segs: List[RunFile]) -> None:
        """Write the merge outputs (lock-free compute phase).  Orphaned on
        crash until the manifest edit lands; recovery GCs them."""
        for rf in new_segs:
            path = self.seg_path(rf.fid)
            nbytes = self._write_segment_timed(path, rf)
            desc = self._segdesc(rf)
            rf.path = path
            rf.loader = self.make_loader(path, desc)
            self.seg_descs[rf.fid] = desc
            self.store.io.segment_write += nbytes

    def on_compact_commit(self, removed_runs: List[RunFile],
                          new_segs: List[RunFile], target_level: int) -> None:
        """In-memory metadata swap done: publish the edit, then drop the
        replaced files (the manifest no longer references them)."""
        self._crashpoint("pre_manifest_compact")
        self._manifest_append({
            "op": "compact", "tau": self.store.tau, "level": target_level,
            "next_fid": self.store._next_fid,
            "remove": sorted(rf.fid for rf in removed_runs),
            "add": [self._segdesc(rf) for rf in new_segs],
        })
        for rf in removed_runs:
            self.seg_descs.pop(rf.fid, None)
            # A pinned snapshot may still hold this RunFile with its arrays
            # evicted; re-materialize before the file goes away so its lazy
            # reload can never hit a missing file.
            if rf.path is not None:
                rf.ensure_loaded()
                try:
                    os.unlink(rf.path)
                except FileNotFoundError:
                    pass

    # ------------------------------------------------------------------ misc
    def sync(self) -> None:
        """Durability barrier (used by the concurrent wrapper's background
        thread and ``close``)."""
        self.wal.sync()

    def sync_upto(self, seq: int) -> None:
        """Per-batch ack: await durability of WAL commit seq ``seq`` only
        (this store's log — a sharded service fsyncs one shard's WAL per
        ack, never its siblings')."""
        self.wal.sync_upto(seq)

    def disk_bytes(self) -> int:
        """Actual bytes on disk: manifest + WAL files + segment files."""
        total = 0
        for path, _dirs, files in os.walk(self.root):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(path, name))
                except OSError:
                    pass
        return total

    def evict_cold_segments(self) -> int:
        """Drop in-RAM arrays of every L1+ segment (reloadable from disk via
        the lazy loader).  Returns the number of runs evicted.  Reads one
        published StoreState — run membership is immutable per state, so no
        store lock is needed (eviction itself is per-RunFile atomic)."""
        n = 0
        for lvl in self.store._state.levels[1:]:
            for rf in lvl:
                n += bool(rf.evict())
        if n:
            _OBS_EVICT.inc(n)
            self.store.drop_read_spine()
        return n

    def evict_all_segments(self) -> int:
        """Drop in-RAM arrays of EVERY level's segments (L0 included) so the
        next read must hit disk — the chaos harness's cold-read lever."""
        n = 0
        for lvl in self.store._state.levels:
            for rf in lvl:
                n += bool(rf.evict())
        if n:
            _OBS_EVICT.inc(n)
            self.store.drop_read_spine()
        return n

    # ------------------------------------------------------------- scrubbing
    def scrub_once(self) -> dict:
        """CRC-verify every live on-disk segment; heal corrupt ones
        (resident arrays -> rewrite in place; else quarantine + rebuild
        from the retained WAL generation; else degrade the range).
        Returns pass statistics."""
        store = self.store
        stats = {"verified": 0, "healed_resident": 0, "rebuilt": 0,
                 "degraded": 0, "transient": 0}
        if store is None:
            return stats
        with self._deg_lock:
            bad = set(self.degraded)
        # One published StoreState is a consistent run-membership snapshot;
        # the scrubber never needs the store's writer locks.
        rfs = [rf for lvl in store._state.levels for rf in lvl
               if rf.path is not None and rf.fid not in bad]
        for rf in rfs:
            try:
                seg_mod.verify_segment(rf.path)
                stats["verified"] += 1
            except CorruptionError as e:
                self._scrub_heal(rf, e, stats)
            except OSError:
                stats["transient"] += 1  # next cadence retries
        for verdict, n in stats.items():
            if n:
                obs.counter("storage_scrub_verdict_total",
                            verdict=verdict).inc(n)
        return stats

    def _scrub_heal(self, rf: RunFile, err: CorruptionError,
                    stats: dict) -> None:
        if rf.arrays is not None:
            # The good bytes are still resident: rewrite in place (atomic
            # tmp+replace), no quarantine needed.
            self.store.io.segment_write += self._write_segment_timed(
                rf.path, rf)
            stats["healed_resident"] += 1
            return
        desc = self.seg_descs.get(rf.fid)
        self.quarantine_segment(rf.path, desc, str(err))
        if desc is not None and scrub_mod.rebuild_segment_from_wal(
                self.wal.dir, desc, rf.path, device=self.device):
            self.mark_rebuilt(desc)
            stats["rebuilt"] += 1
        else:
            stats["degraded"] += 1

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.scrubber is not None:
            self.scrubber.stop()
        self.wal.close()
        self.manifest.close()
        try:
            fcntl.lockf(self._lock_fd, fcntl.LOCK_UN)
        finally:
            os.close(self._lock_fd)


def open_store(root: str, cfg: Optional[StoreConfig] = None, *,
               device=None, wal_sync: str = "batch",
               wal_sync_interval: float = 0.05,
               wal_retain: int = 2, on_corruption: str = "degrade",
               scrub_interval: Optional[float] = None) -> LSMGraph:
    """Open (or create) a durable ``LSMGraph`` rooted at ``root``.

    Fresh directory: requires ``cfg``; writes the manifest "open" record.
    Existing directory: recovers (manifest replay + segment load + WAL tail
    replay); ``cfg`` may be omitted — it is restored from the manifest.
    ``device``: where the store's tensors live (None: the current CUDA
    card; raises when there is none).  A directory written on one device
    (or by the JAX package) opens on any other.

    Failure handling knobs (see the package docstring's failure model):
    ``wal_retain`` keeps that many prunable WAL generations for segment
    rebuild; ``on_corruption`` = "degrade" serves around an unrebuildable
    corrupt segment (its vertex range reported degraded) while "raise"
    fails the open; ``scrub_interval`` (seconds) arms background CRC
    scrubbing."""
    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    if Manifest.exists(root):
        # A crash during the very first "open" append leaves an empty/torn
        # manifest with zero valid records; no write can have happened before
        # that record landed, so the directory is safely re-creatable.
        if Manifest.load_state(root).n_records > 0:
            from .recovery import recover
            return recover(root, cfg, device=device, wal_sync=wal_sync,
                           wal_sync_interval=wal_sync_interval,
                           wal_retain=wal_retain, on_corruption=on_corruption,
                           scrub_interval=scrub_interval)
        # Drop the dead file: appending after a torn line would corrupt the
        # fresh "open" record too (replay stops at the first bad line).
        from .manifest import MANIFEST_NAME
        os.unlink(os.path.join(root, MANIFEST_NAME))
    if cfg is None:
        raise ValueError(f"{root}: no usable manifest found and no config "
                         "given")
    storage = DurableStorage(root, device=device, wal_sync=wal_sync,
                             wal_sync_interval=wal_sync_interval,
                             wal_retain=wal_retain, on_corruption=on_corruption,
                             scrub_interval=scrub_interval)
    storage._manifest_append({
        "op": "open", "format": 1, "config": dataclasses.asdict(cfg)})
    return LSMGraph(cfg, device=device, durability=storage)
