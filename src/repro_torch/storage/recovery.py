"""Crash recovery: reopen a durable LSMGraph directory (the port of
``repro.storage.recovery``; segments load onto the store's device).

Protocol (package docstring has the full spec):

  1. fold the manifest edit-log into the live segment set + τ + WAL floor;
  2. load live segments (mmap + CRC), GC orphan files from crashed
     flush/compaction attempts;
  3. rebuild the multi-level index the live store held: ``l0_min_fid``
     from the manifest's history of L0 compactions, the first L0 file of
     each vertex from the live L0 runs, and each level's column from its
     live runs, each run writing its own vertex range only.  (The JAX
     package replays ``note_compaction`` for every L1+ run, which for an
     L2 run clears the L1 column over the run's range and so drops the
     entries of live L1 runs that overlap it — ROADMAP, faults of the
     reference — and restarts ``l0_min_fid`` at 0);
  4. replay the WAL tail (records with ts >= floor) into a fresh MemGraph
     with the *original* timestamps — flushes triggered mid-replay follow
     the normal durable path, advancing the floor as they land;
  5. resume τ and fid allocation past everything seen.

The reopened store's ``edge_set()`` equals the pre-crash snapshot.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..core import filters
from ..core import index as mlindex
from ..core.store import LSMGraph
from ..core.types import RunFile, StoreConfig
from . import scrub as scrub_mod
from . import segments as seg_mod
from .engine import SEGMENT_DIR, WAL_DIR, DurableStorage
from .errors import CorruptionError, DegradedRange, retry_transient
from .manifest import Manifest
from .wal import scan_wal_dir


def recover(root: str, cfg: Optional[StoreConfig] = None, *,
            device=None, wal_sync: str = "batch",
            wal_sync_interval: float = 0.05,
            wal_retain: int = 2, on_corruption: str = "degrade",
            scrub_interval: Optional[float] = None) -> LSMGraph:
    """Reopen ``root``; returns a durable ``LSMGraph`` with the pre-crash
    state restored."""
    st = Manifest.load_state(root)
    if st.config is None:
        raise ValueError(f"{root}: manifest has no open record")
    if cfg is None:
        cfg = StoreConfig(**st.config)
    else:
        for key in ("vmax", "n_levels"):
            if st.config.get(key) != getattr(cfg, key):
                raise ValueError(
                    f"{root}: config mismatch on {key}: "
                    f"stored {st.config.get(key)} != given {getattr(cfg, key)}")

    # -- WAL scan first: records are held in memory so replay survives the
    #    rotations/prunes that replay-triggered flushes perform.
    wal_records, wal_last_ts, wal_max_seq = scan_wal_dir(
        os.path.join(root, WAL_DIR))

    storage = DurableStorage(
        root, device=device, wal_sync=wal_sync,
        wal_sync_interval=wal_sync_interval,
        wal_start_seq=wal_max_seq + 1, wal_last_ts=wal_last_ts,
        wal_retain=wal_retain, on_corruption=on_corruption,
        scrub_interval=scrub_interval)
    try:
        return _recover_into(storage, root, cfg, st, wal_records)
    except BaseException:
        # A failed recovery (corrupt segment, manifest disagreement,
        # replay overflow) must not leak the LOCK fd, the WAL fsync
        # thread, or the freshly-created wal file handle per attempt.
        storage.close()
        raise


def _recover_into(storage: DurableStorage, root: str, cfg: StoreConfig,
                  st, wal_records) -> LSMGraph:
    # Build empty on the storage's device, then restore state.
    store = LSMGraph(cfg, device=storage.device, durability=None)
    seg_dir = os.path.join(root, SEGMENT_DIR)
    wal_dir = os.path.join(root, WAL_DIR)

    # -- previously-quarantined ranges: retry the WAL rebuild first (the
    #    retained generation may still be on disk even if the last
    #    incarnation's serving path could not repair inline).
    for fid, qrec in sorted(st.quarantined.items()):
        desc = qrec.get("desc")
        if desc is not None and scrub_mod.rebuild_segment_from_wal(
                wal_dir, desc, os.path.join(seg_dir, desc["file"]),
                device=storage.device):
            storage.mark_rebuilt(desc)
            st.segments[fid] = desc
        elif desc is not None:
            if storage.on_corruption == "raise":
                raise CorruptionError(
                    f"segment fid={fid} is quarantined and not rebuildable",
                    fid=fid)
            with storage._deg_lock:
                storage.degraded[fid] = DegradedRange(
                    int(desc["min_vid"]), int(desc["max_vid"]), int(fid),
                    qrec.get("reason", "quarantined"))

    # -- load live segments; GC orphans (crashed publish attempts).  The
    #    level lists are built LOCALLY and installed as one published
    #    StoreState below — recovery never mutates serving state in place.
    live_files = {desc["file"] for desc in st.segments.values()}
    for name in os.listdir(seg_dir):
        if name not in live_files:
            try:
                os.unlink(os.path.join(seg_dir, name))
            except OSError:
                pass
    levels = [[] for _ in range(cfg.n_levels)]
    for fid in sorted(st.segments):
        desc = st.segments[fid]
        path = os.path.join(seg_dir, desc["file"])
        try:
            run = _load_checked(store, path, desc)
        except CorruptionError as e:
            # Quarantine + rebuild from the retained WAL generation; an
            # unrebuildable segment degrades its range (serve around it)
            # or fails the open, per policy.
            storage.quarantine_segment(path, desc, str(e))
            if scrub_mod.rebuild_segment_from_wal(wal_dir, desc, path,
                                                  device=storage.device):
                storage.mark_rebuilt(desc)
                run = _load_checked(store, path, desc)
            elif storage.on_corruption == "raise":
                raise
            else:
                continue
        rf = RunFile(
            fid=fid, level=desc["level"], arrays=run,
            min_vid=desc["min_vid"], max_vid=desc["max_vid"],
            created_ts=desc["created_ts"], nv=desc["nv"], ne=desc["ne"],
            path=path, loader=storage.make_loader(path, desc), io=store.io,
            presence=_recover_presence(path, run, desc))
        storage.seg_descs[fid] = desc
        levels[rf.level].append(rf)
    for lvl in range(cfg.n_levels):
        levels[lvl].sort(
            key=(lambda r: r.fid) if lvl == 0 else (lambda r: r.min_vid))

    # -- rebuild the multi-level index: the min readable L0 fid each L0
    #    compaction left, the first L0 file of each vertex, and for each
    #    level one pass that names every live run at its own vertices.  A
    #    level's runs are disjoint, so no run clears another's entries, and
    #    no other level's column is touched.
    idx = mlindex.empty_index(cfg.vmax, cfg.n_levels, storage.device)
    for l0_min, ranges in _l0_compactions(Manifest.replay(root)):
        idx = mlindex.note_compaction_many(
            idx, level=1, writes=[], ranges=ranges, src_ranges=[],
            l0_min_fid_update=l0_min)
    for rf in levels[0]:
        idx = mlindex.note_l0_flush(idx, rf.arrays.vkeys, rf.nv, rf.fid)
    for lvl in range(1, cfg.n_levels):
        if levels[lvl]:
            idx = mlindex.note_compaction_many(
                idx, level=lvl,
                writes=[(rf.arrays.vkeys, rf.arrays.voff, rf.nv, rf.fid)
                        for rf in levels[lvl]],
                ranges=[(rf.min_vid, rf.max_vid + 1) for rf in levels[lvl]],
                src_ranges=[], l0_min_fid_update=-1)
    # Resume τ at the DURABLE floor, not past it: every segment record has
    # ts < wal_floor (a flush persists exactly the records below its
    # rotation boundary), and the WAL tail replays with original ts — so
    # τ tracks "last replayed + 1" through replay.  Inflating τ here (e.g.
    # to a segment's wrap-time created_ts) would poison the wal_floor of a
    # replay-triggered flush with a value ABOVE still-unreplayed records,
    # and a second crash mid-replay would then drop them at the next
    # recovery's `ts >= floor` filter.
    store._install_recovered(
        levels, idx, tau=st.wal_floor,
        next_fid=max(st.next_fid, max(st.segments, default=-1) + 1))

    # -- attach durability BEFORE replay: replay-triggered flushes must run
    #    the normal durable path (segment write + manifest edit + prune).
    store.durability = storage
    storage.attach(store)

    # -- replay the WAL tail with original timestamps.
    floor = st.wal_floor
    for (_seq, src, dst, ts, marker, prop) in wal_records:
        keep = np.asarray(ts) >= floor
        if not keep.any():
            continue
        store._ingest_replay(np.asarray(src)[keep], np.asarray(dst)[keep],
                             np.asarray(ts)[keep],
                             np.asarray(marker)[keep],
                             np.asarray(prop)[keep])
    return store


def _l0_compactions(records):
    """(min readable L0 fid, vertex ranges) of every L0 -> L1 compaction in
    the manifest's history, in order: what each one's commit set
    ``l0_min_fid`` to (max compacted L0 fid + 1) over the compacted range
    and its output segments' ranges (``LSMGraph._commit_merge``)."""
    descs = {}
    out = []
    for rec in records:
        if rec.get("op") == "compact" and int(rec.get("level", 0)) == 1:
            l0 = [descs[f] for f in map(int, rec.get("remove", ()))
                  if f in descs and int(descs[f]["level"]) == 0
                  and int(descs[f]["nv"]) > 0]
            if l0:
                lo = min(int(d["min_vid"]) for d in l0)
                hi = max(int(d["max_vid"]) for d in l0) + 1
                ranges = [(lo, hi)] + [
                    (int(d["min_vid"]), int(d["max_vid"]) + 1)
                    for d in rec.get("add", ())]
                out.append((max(int(d["fid"]) for d in l0) + 1, ranges))
        for d in rec.get("add", ()):
            descs[int(d["fid"])] = d
    return out


def _recover_presence(path: str, run, desc: dict):
    """Presence filter for a recovered segment: rehydrate the v2 file
    section when it reads clean, else derive from the (already loaded,
    already CRC'd) arrays — same words by determinism.  Covers v1 legacy
    files and rotten sections alike; a bad section is left for the
    scrubber's ``verify_segment`` pass to heal."""
    try:
        filt = seg_mod.read_segment_filter(path)
    except (CorruptionError, OSError):
        filt = None
    if filt is not None:
        return filt
    nv = int(desc["nv"])
    return filters.from_vkeys(run.vkeys[:nv].cpu().numpy())


def _load_checked(store: LSMGraph, path: str, desc: dict):
    """Segment load for recovery: bounded retry on transient I/O, typed
    ``CorruptionError`` when the header disagrees with the manifest."""
    def attempt():
        return seg_mod.read_segment(path, device=store.device)

    def note(_e):
        store.io.read_retries += 1

    meta, run = retry_transient(attempt, on_retry=note)
    store.io.segment_read += os.path.getsize(path)
    for key in ("fid", "level", "min_vid", "max_vid", "nv", "ne"):
        if meta[key] != desc[key]:
            raise CorruptionError(
                f"{path}: header {key}={meta[key]} disagrees with "
                f"manifest {desc[key]}", fid=desc["fid"])
    return run


__all__ = ["recover"]
