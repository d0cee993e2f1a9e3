"""Durable storage engine: WAL + segment files + manifest + crash recovery.

The port of ``repro.storage``.  The on-disk formats below are the JAX
package's, byte for byte, so a directory written by either package opens
in the other.  Run arrays are written from, and loaded back onto, the
store's device (``open_store(root, cfg, device=None)``: the current CUDA
card unless the caller passes ``device="cpu"``).

The paper's premise is a *disk-based* dynamic graph store; this package gives
the in-memory LSMGraph its durability machinery, following the classic LSM
recipe (Luo & Carey's survey; RocksDB/LevelDB lineage):

  * ``wal.py``       — append-only write-ahead log.  Every ``EdgeBatch``
    entering MemGraph is appended first; group-commit batching keeps fsync
    off the ingest critical path.
  * ``segments.py``  — serializer for immutable CSR segment files (the
    paper's "CSR file" + "property file", Fig. 6), written at MemGraph
    flush and compaction commit, mmap-loadable so cold L1+ levels can be
    evicted from RAM and reloaded on demand.
  * ``manifest.py``  — versioned edit-log of LSM membership (level → files,
    τ, WAL floor).  One fsync'd record per publish makes flush and
    compaction commits crash-atomic.
  * ``engine.py``    — ``DurableStorage``, the hook object ``LSMGraph``
    calls at apply/flush/compaction time, plus ``open_store``.
  * ``recovery.py``  — reopens a directory: replay the manifest, load live
    segments, rebuild the multi-level index, replay the WAL tail into a
    fresh MemGraph.
  * ``crashtest.py`` — subprocess child for SIGKILL crash-recovery tests.
  * ``errors.py``    — typed failure taxonomy + bounded retry policy.
  * ``faultfs.py``   — deterministic fault-injection seam every fsync /
    write / segment-read in this package routes through (zero-cost when
    disarmed: one ``is None`` check).
  * ``scrub.py``     — segment quarantine + WAL rebuild + the background
    scrubber thread.
  * ``chaostest.py`` — randomized fault-schedule harness
    (``python -m repro_torch.storage.chaostest``).

Directory layout
----------------

::

    <root>/
      MANIFEST.log          append-only edit log (JSON lines + CRC)
      wal/wal-<seq>.log     write-ahead log files, rotated at every flush
      segments/seg-<fid>.csr  immutable CSR segment files

On-disk segment format (``seg-<fid>.csr``)
------------------------------------------

Little-endian throughout.  A fixed 64-byte header followed by a topology
section and a property section (mirroring the paper's separate CSR/property
files, packed into one segment for atomic replace):

====== ======= ==========================================================
offset size    field
====== ======= ==========================================================
0      8       magic ``b"LSMGSEG1"``
8      4       format version (u32, currently 1)
12     4       header CRC32 (over bytes [0, 64) with this field zeroed)
16     4       body CRC32 (over bytes [64, EOF))
20     4       level (i32)
24     8       fid (i64)
32     8       min_vid (i64)
40     8       max_vid (i64)
48     8       created_ts (i64)
56     4       nv (u32) — valid vertices
60     4       ne (u32) — valid edges
====== ======= ==========================================================

Body (only valid prefixes are stored; capacities are re-quantized at load):

* topology section: ``vkeys  i32[nv]``, ``voff  i32[nv+1]``,
  ``dst  i32[ne]``, ``ts  i32[ne]``, ``marker  u8[ne]``
* property section: ``prop  f32[ne]``

Segment files are written to a temp name, fsync'd, then atomically
``os.replace``'d into place (followed by a directory fsync).

WAL record format (``wal-<seq>.log``)
-------------------------------------

A stream of records, each::

    magic u32 (0x314C4157 "WAL1") | payload CRC32 u32 | payload len u32 |
    record type u8 | 3 pad bytes | payload

Record type 1 (edge batch) payload::

    n u32 | src i32[n] | dst i32[n] | ts i32[n] | marker u8[n] | prop f32[n]

Replay stops at the first short/corrupt record — a torn tail from a crash
mid-``write`` loses only the unacknowledged suffix.  WAL files rotate at
every MemGraph flush (so one file covers exactly one MemGraph generation)
and are pruned once the manifest's ``wal_floor`` passes their last ts.

Manifest record schema (``MANIFEST.log``)
-----------------------------------------

One JSON object per line, suffixed with `` #<crc32 hex>`` of the JSON text;
a torn last line is ignored at replay.  Records:

* ``{"op": "open", "format": 1, "config": {<StoreConfig fields>}}`` —
  written once at store creation.
* ``{"op": "flush", "tau": t, "wal_floor": t, "next_fid": f,
  "add": [<segdesc>]}`` — a MemGraph flush landed at L0.  ``wal_floor``
  asserts every record with ``ts < wal_floor`` is durable in segments.
* ``{"op": "compact", "tau": t, "level": L, "next_fid": f,
  "remove": [fid, ...], "add": [<segdesc>, ...]}`` — a compaction commit:
  the removed files' contents are fully represented by the added files.

``segdesc`` is ``{"fid", "level", "file", "min_vid", "max_vid",
"created_ts", "nv", "ne"}``.

Recovery protocol
-----------------

1. Replay ``MANIFEST.log``: fold edits into the live segment set
   ``{fid → segdesc}``, final ``tau``, ``wal_floor`` and ``next_fid``.
2. Load every live segment (mmap + CRC check), garbage-collect orphan
   segment files (written by a crashed flush/compaction whose manifest
   edit never landed).
3. Rebuild the multi-level index from membership: ``note_l0_flush`` per
   live L0 run in fid order, then one ``note_compaction_many`` per level
   naming each live L1+ segment at its own vertices and clearing no other
   level (no old reader pins survive a restart, so every live L0 file is
   readable and ``l0_min_fid`` restarts at 0).
4. Scan WAL files in seq order, drop records with ``ts < wal_floor``, and
   re-insert the tail into a fresh MemGraph with the *original* timestamps
   (flushes triggered during replay follow the normal durable path).
5. ``τ`` resumes at ``wal_floor`` and advances through replay to
   ``last replayed ts + 1`` (never past an unreplayed record: a
   replay-triggered flush must publish a ``wal_floor`` that is true) —
   the reopened ``edge_set()`` equals the pre-crash snapshot.

Failure model
-------------

The engine assumes disks fail in four ways and answers each with a typed
error (``errors.py``) and a bounded recovery action — never a silent wrong
answer, never an unbounded retry:

* **Transient read I/O** (``TransientIOError``, carries ``transient =
  True``): a cold segment read hits EIO.  Retried with bounded exponential
  backoff + wall-clock deadline at exactly ONE layer
  (``RunFile.ensure_loaded``, under the load lock, so foreground loads and
  background prefetch never stack retries); retry counts land in
  ``IOCounters.read_retries`` / ``prefetch_retries``.  Exhaustion
  propagates the typed error.
* **Failed fsync** (``DurabilityLost``): fsyncgate semantics — the kernel
  may mark pages clean after a FAILED fsync, so a retry that "succeeds"
  proves nothing.  The WAL (and manifest) latch a sticky fail-stop flag on
  the first failure: the raising call surfaces the raw ``OSError``, every
  later append/sync/publish raises ``DurabilityLost``.  A torn WAL
  ``write`` latches the same flag (replay stops at the torn record, so
  later appends would be silently dropped even if durable).  Recovery =
  reopen from disk state.
* **Detected corruption** (``CorruptionError``, carries ``fid`` +
  ``DegradedRange``s): a segment fails its CRC.  The serving path fails
  FAST — quarantine the file (``quarantine/``), publish a manifest
  ``quarantine`` event, mark the vertex range degraded, raise typed; no
  inline repair on the read path.  Repair is off-path: the background
  ``Scrubber`` (or the next reopen) rewrites resident arrays in place, or
  rebuilds L0 flush segments byte-identically from their retained WAL
  generation (``wal_retain``; each flush segment records its ``wal_seq``).
  Queries overlapping a still-degraded range raise ``CorruptionError``;
  everything else keeps serving (``on_corruption="degrade"``, the default
  — ``"raise"`` fails the open instead).
* **Lost durability at the shard tier** (``repro_torch.shard``): a
  shard's latched/corrupt state maps to per-shard fencing, and a reopen of
  that shard's directory (``ShardedGraphStore.reopen_shard``) heals it.

``faultfs`` is the injection seam for all of the above; the invariants are
enforced by ``chaostest.run_schedule`` (randomized schedules: acked writes
survive reopen modulo explicitly-reported degraded ranges, unacked writes
are never claimed durable, readers only ever see typed errors).
"""
from __future__ import annotations

from .engine import DurableStorage, SimulatedCrash, open_store
from .errors import (CorruptionError, DegradedRange, DurabilityLost,
                     StorageError, TransientIOError, retry_transient)
from .faultfs import FaultPlan, FaultRule, fault_plan
from .manifest import Manifest
from .scrub import Scrubber
from .segments import (read_segment, read_segment_header, verify_segment,
                       write_segment)
from .wal import WalAppend, WriteAheadLog

__all__ = [
    "CorruptionError", "DegradedRange", "DurabilityLost", "DurableStorage",
    "FaultPlan", "FaultRule", "Manifest", "Scrubber", "SimulatedCrash",
    "StorageError", "TransientIOError", "WalAppend", "WriteAheadLog",
    "fault_plan", "open_store", "read_segment", "read_segment_header",
    "retry_transient", "verify_segment", "write_segment",
]
