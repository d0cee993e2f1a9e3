"""Segment quarantine + scrubbing (the port of ``repro.storage.scrub``).

Policy layering for corrupt segments (who repairs what):

* the SERVING-path loader (``engine.make_loader``) fails fast — quarantine
  the file, record the manifest event, mark the vertex range degraded, and
  raise ``CorruptionError``.  No inline repair: a reader thread must never
  block on a WAL rebuild.
* the SCRUBBER (this module) heals off-path: it CRC-verifies live segments
  on an idle cadence; a corrupt segment whose arrays are still resident in
  RAM is rewritten from them in place, otherwise it is quarantined and
  rebuilt from the retained WAL generation.
* RECOVERY (reopen) attempts the same WAL rebuild for segments that fail
  to load and for ranges quarantined in a previous incarnation.

Rebuild-from-WAL exactness: one closed WAL generation holds exactly one
MemGraph generation — the record multiset an L0 flush segment was built
from.  ``csr.build_run_arrays`` lexsorts by (src, dst, ts) with globally
unique ts, so rebuilding from the WAL records reproduces the original
segment byte-for-byte (the port sorts it on the store's device).  Only
L0 flush segments carry a ``wal_seq`` in their manifest descriptor;
compaction outputs merge + GC records and are not WAL-rebuildable
(their range degrades if both the file and the scrub window are lost).
"""
from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from ..core import csr
from ..core.types import RunFile, resolve_device
from . import segments as seg_mod
from . import wal as wal_mod
from .fsutil import fsync_dir

QUARANTINE_DIR = "quarantine"


def quarantine_file(root: str, path: str) -> Optional[str]:
    """Move a corrupt file under ``<root>/quarantine/`` (kept for forensics
    rather than deleted).  Returns the new path, or None if the file was
    already gone."""
    qdir = os.path.join(root, QUARANTINE_DIR)
    os.makedirs(qdir, exist_ok=True)
    qpath = os.path.join(qdir, os.path.basename(path))
    try:
        os.replace(path, qpath)
    except FileNotFoundError:
        return None
    try:
        fsync_dir(qdir)
        fsync_dir(os.path.dirname(path))
    except OSError:
        pass  # the move is advisory; reopen re-detects a half-moved file
    return qpath


def rebuild_segment_from_wal(wal_dir: str, desc: dict, seg_path: str, *,
                             device=None) -> bool:
    """Rebuild the L0 flush segment described by ``desc`` from its retained
    WAL generation, writing the result to ``seg_path``.  Returns True on a
    verified rebuild, False when the generation is gone / doesn't match
    (pruned WAL, compaction output, cross-check failure).  ``device``: where
    the run is sorted (None: the current CUDA card)."""
    wal_seq = desc.get("wal_seq")
    if wal_seq is None or int(wal_seq) < 0:
        return False
    gen_path = os.path.join(wal_dir, wal_mod._FILE_FMT % int(wal_seq))
    if not os.path.exists(gen_path):
        return False
    recs = list(wal_mod.iter_file_records(gen_path))
    if not recs:
        return False
    src = np.concatenate([r[0] for r in recs]).astype(np.int32)
    dst = np.concatenate([r[1] for r in recs]).astype(np.int32)
    ts = np.concatenate([r[2] for r in recs]).astype(np.int32)
    marker = np.concatenate([r[3] for r in recs]).astype(bool)
    prop = np.concatenate([r[4] for r in recs]).astype(np.float32)
    n = len(src)
    if n != int(desc["ne"]):
        return False  # generation doesn't cover exactly this segment
    cap = csr.quantize_cap(n)
    pad = cap - n
    dev = resolve_device(device)

    def up(a):
        return torch.from_numpy(np.pad(a, (0, pad))).to(dev)

    run = csr.build_run_arrays(up(src), up(dst), up(ts), up(marker),
                               up(prop), n, vcap=cap)
    run = csr.repad_run(run, cap, cap)
    if int(run.nv) != int(desc["nv"]):
        return False
    rf = RunFile(
        fid=int(desc["fid"]), level=int(desc["level"]), arrays=run,
        min_vid=int(desc["min_vid"]), max_vid=int(desc["max_vid"]),
        created_ts=int(desc["created_ts"]), nv=int(desc["nv"]),
        ne=int(desc["ne"]))
    seg_mod.write_segment(seg_path, rf)
    seg_mod.verify_segment(seg_path)  # never publish an unverified rebuild
    return True


class Scrubber:
    """Background thread CRC-verifying live segments on an idle cadence and
    feeding corrupt ones into the heal path (``DurableStorage.scrub_once``)."""

    def __init__(self, storage, interval: float):
        self.storage = storage
        self.interval = interval
        self.last_stats: dict = {}
        self.passes = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="seg-scrub")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.last_stats = self.storage.scrub_once()
                self.passes += 1
            except Exception:
                pass  # scrubbing is best-effort; next cadence retries


__all__ = ["QUARANTINE_DIR", "quarantine_file", "rebuild_segment_from_wal",
           "Scrubber"]
