"""``ShardedGraphStore``: n_shards independent LSMGraphs behind one facade.

The port of ``repro.shard.store``.  Every shard is an ``LSMGraph`` of the
port on one device (``device=None``: the current CUDA card; raises when
there is none).  The shards of one store share that device: the fan-out
runs each shard's resolve and apply on a pool thread, and every thread
launches on the device's default stream, as the single store's readers,
writer and compactor do.

Write path:   updates bucket by owner shard (``router.bucket_edge_batches``)
              and apply shard-locally in parallel under the coordinator
              epoch; durable shards return per-shard WAL commit seqs in a
              ``ShardWriteReceipt`` — ``ack(receipt)`` awaits fsync of each
              shard's OWN batch only (``WriteAheadLog.sync_upto``), never a
              global barrier.
Read path:    ``ShardedSnapshot`` pins one ``Snapshot`` per shard under the
              same epoch; ``neighbors_batch`` routes the query vector to
              owning shards, resolves each sub-vector with that shard's
              ``Snapshot.neighbors_batch``, and inverse-permutes the gathered
              results back to caller order.
Consistency:  the tau-epoch protocol (see the ``shard`` package
              docstring) — every write batch applies to ALL its owner
              shards under the epoch lock, and snapshots collect per-shard
              taus under that same lock, so a multi-shard read never
              observes half a batch.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..core.store import LSMGraph, Snapshot, slice_adjacency
from ..core.types import StoreConfig, resolve_device
from ..storage import fsutil
from ..storage.errors import (CorruptionError, DegradedRange, DurabilityLost,
                              StorageError)
from . import router
from .partition import RangePartition, shard_scaled_config

SHARD_DIR_FMT = "shard-%02d"
SHARD_META = "SHARDS.json"


class ShardUnavailable(RuntimeError):
    """Write backpressure: the batch touches at least one fenced shard.
    Nothing was applied anywhere — retry after ``reopen_shard`` heals the
    fenced member(s)."""

    def __init__(self, msg: str, *, shards: Sequence[int] = ()):
        super().__init__(msg)
        self.shards = tuple(shards)


class DegradedReport(NamedTuple):
    """What a sharded read could NOT answer: the fenced/degraded shards,
    the unavailable vertex ranges, and the query positions whose results
    were masked to empty because of them."""

    shards: Tuple[int, ...]
    ranges: Tuple[DegradedRange, ...]
    positions: np.ndarray  # indices into the caller's query vector

    @property
    def ok(self) -> bool:
        return len(self.positions) == 0


def _run_calls_settled(pool: ThreadPoolExecutor, calls: list) -> list:
    """Run ``(fn, args)`` pairs via ``pool``; returns ``(result, error)``
    per call — every future is drained, no exception escapes.  Calls that
    could not be submitted (pool shut down — e.g. a read on a pinned
    snapshot, or an ack racing ``close()``) run inline instead;
    already-submitted futures are always awaited, never re-executed."""
    futs = []
    for fn, args in calls:
        try:
            futs.append(pool.submit(fn, *args))
        except RuntimeError:
            futs.append(None)
    settled = []
    for (fn, args), f in zip(calls, futs):
        try:
            settled.append((f.result() if f is not None else fn(*args), None))
        except BaseException as e:
            settled.append((None, e))
    return settled


def _run_calls(pool: ThreadPoolExecutor, calls: list) -> list:
    """``_run_calls_settled`` with the original raise-first-error contract:
    EVERY future is drained before the first error propagates, so no
    per-shard work is left in flight against state (pinned snapshots, open
    WALs) the caller may tear down right after catching the exception."""
    settled = _run_calls_settled(pool, calls)
    for _res, err in settled:
        if err is not None:
            raise err
    return [res for res, _err in settled]


class ShardWriteReceipt(NamedTuple):
    """Ack token for one routed write batch.

    ``seqs`` maps shard -> WAL commit seq for every durable shard that
    received part of the batch (empty for in-memory stores); ``epoch`` is
    the coordinator epoch the batch committed under.
    """

    epoch: int
    seqs: Dict[int, int]


class ShardedSnapshot:
    """A cross-shard consistent read view: one pinned ``Snapshot`` per shard,
    all collected under the same coordinator epoch."""

    def __init__(self, part: RangePartition, snaps: Sequence[Snapshot],
                 epoch: int, pool: ThreadPoolExecutor,
                 fenced: Optional[Dict[int, str]] = None,
                 owner: Optional["ShardedGraphStore"] = None):
        self.part = part
        self.snaps = list(snaps)       # entry is None for a fenced shard
        self.epoch = epoch
        self.taus: Tuple[int, ...] = tuple(
            (-1 if s is None else s.tau) for s in self.snaps)
        self.fenced: Dict[int, str] = dict(fenced or {})
        self._owner = owner
        self._pool = pool
        self._released = False

    def _map_shards(self, calls: list) -> list:
        """Pool fan-out with inline fallback: a snapshot pinned before the
        store closed must stay readable (the single-store contract)."""
        return _run_calls(self._pool, calls)

    def _note_failure(self, s: int, err: BaseException) -> None:
        """A shard failed mid-read.  Corruption / lost durability fences the
        shard at the store (stop routing writes, future snapshots skip it);
        a transient I/O failure only degrades THIS read — the next snapshot
        retries the shard."""
        if (isinstance(err, (CorruptionError, DurabilityLost))
                and self._owner is not None):
            self._owner.fence(s, err)

    def _unavailable(self, uniq: np.ndarray):
        """Mask over the SORTED unique query vector: True where the owning
        shard is fenced (no pinned snapshot) or the vertex falls inside a
        degraded range pinned by the owner's snapshot.  Returns
        ``(mask, shards, ranges)`` feeding the ``DegradedReport``."""
        mask = np.zeros(len(uniq), bool)
        shards: List[int] = []
        ranges: List[DegradedRange] = []
        for s in range(self.part.n_shards):
            r_lo, r_hi = self.part.shard_range(s)
            lo_i = int(np.searchsorted(uniq, r_lo))
            hi_i = int(np.searchsorted(uniq, r_hi))
            if hi_i <= lo_i:
                continue
            if self.snaps[s] is None:
                mask[lo_i:hi_i] = True
                shards.append(s)
                ranges.append(DegradedRange(
                    int(r_lo), int(r_hi) - 1, -1,
                    f"shard {s} fenced: {self.fenced.get(s, 'fenced')}"))
                continue
            view = mask[lo_i:hi_i]
            sub = uniq[lo_i:hi_i]
            for r in getattr(self.snaps[s], "degraded", ()):
                hit = (sub >= r.lo) & (sub <= r.hi)
                if hit.any():
                    view[hit] = True
                    if s not in shards:
                        shards.append(s)
                    ranges.append(r)
        return mask, shards, ranges

    # ------------------------------------------------------------------ reads
    def neighbors_batch(self, vs, return_props: bool = False,
                        with_report: bool = False):
        """Adjacency of every vertex in ``vs`` — route, per-shard batched
        resolve, gather + inverse permutation.  Element-wise identical to a
        single store holding the union of all shards (the oracle the shard
        tests compare against); no-shard vertices resolve to empty arrays.

        Degraded-mode serving: vertices owned by a fenced shard, or falling
        inside a degraded (quarantined-segment) range, are MASKED — their
        results come back empty and healthy shards still answer, instead of
        one bad disk panicking the whole fan-out.  A shard that fails
        mid-resolve with a typed ``StorageError`` is fenced and its
        positions join the mask; any other exception still propagates.
        Pass ``with_report=True`` to get ``(results, DegradedReport)`` —
        the report names the masked positions, shards, and vertex ranges
        (``report.ok`` is True on a fully-healthy read).

        Routing piggybacks on the sort the batched read path needs anyway:
        the SORTED unique query vector splits into per-shard contiguous
        slices (range partition => owner is monotone in vertex id), each
        shard resolves its slice with one ``_resolve_batch_chunked`` device
        pipeline, and the per-shard ``(offsets, dst, prop)`` triples
        concatenate back IN ORDER — dedup, routing, and per-query output
        assembly each happen once globally, not once per shard."""
        vs = np.asarray(vs, np.int64).ravel()
        if vs.size == 0:
            rep = DegradedReport((), (), np.empty(0, np.int64))
            return ([], rep) if with_report else []
        uniq, inv = np.unique(vs, return_inverse=True)
        B = len(uniq)
        mask, bad_shards, bad_ranges = self._unavailable(uniq)
        empty_one = ((np.empty(0, np.int64), np.empty(0, np.float32))
                     if return_props else np.empty(0, np.int64))
        if B == 1:
            # Keep the single-store point-read fast path: the owning
            # shard's neighbors_batch takes its O(degree) scalar shortcut
            # instead of a capacity-shaped batched resolve.
            owner = int(self.part.owner_of(uniq)[0])
            one = empty_one
            if owner >= 0 and not mask[0]:
                try:
                    one = self.snaps[owner].neighbors_batch(
                        uniq, return_props=return_props)[0]
                except StorageError as e:
                    if not with_report:
                        raise
                    self._note_failure(owner, e)
                    mask[0] = True
                    bad_shards.append(owner)
                    bad_ranges.extend(
                        getattr(e, "ranges", ())
                        or (DegradedRange(int(uniq[0]), int(uniq[0]),
                                          -1, str(e)),))
            out = [one] * len(vs)
            if with_report:
                pos = (np.arange(len(vs), dtype=np.int64) if mask[0]
                       else np.empty(0, np.int64))
                return out, DegradedReport(tuple(dict.fromkeys(bad_shards)),
                                           tuple(bad_ranges), pos)
            return out
        counts = np.zeros(B, np.int64)
        slices = []   # (shard, index vector into uniq — mask holes removed)
        for s in range(self.part.n_shards):
            if self.snaps[s] is None:
                continue
            r_lo, r_hi = self.part.shard_range(s)
            lo_i = int(np.searchsorted(uniq, r_lo))
            hi_i = int(np.searchsorted(uniq, r_hi))
            if hi_i <= lo_i:
                continue
            idx = lo_i + np.nonzero(~mask[lo_i:hi_i])[0]
            if len(idx):
                slices.append((s, idx))
        # Kick EVERY shard's cold-segment loads onto the shared prefetch
        # pool before the first resolve dispatches: a late shard in the
        # fan-out order has its segments resident (or in flight) by the
        # time a worker reaches it, instead of paying the load serially in
        # router order.  Shards whose read spine is already built never
        # touch segment arrays again — skip those.  A load still in flight
        # when the shard's resolve reaches the run is joined, not raced:
        # ``RunFile.ensure_loaded`` serializes on the run's load lock, and
        # the loader's upload is synchronous, so a published run's arrays
        # are on the device before the resolve's kernels read them.
        for (s, idx) in slices:
            if not self.snaps[s].spine_ready():
                self.snaps[s]._prefetch_range(int(uniq[idx[0]]),
                                              int(uniq[idx[-1]]))
        settled = _run_calls_settled(
            self._pool,
            [(self.snaps[s]._resolve_batch_chunked, (uniq[idx],))
             for (s, idx) in slices])
        dst_parts, prop_parts = [], []
        for (s, idx), (res, err) in zip(slices, settled):
            if err is not None:
                if not isinstance(err, StorageError):
                    raise err
                # Mid-read failure (cold segment turned out corrupt, I/O
                # error past the retry budget): degrade this shard's
                # positions instead of panicking the reader.  counts stays
                # 0 there, so the in-order concat below is unaffected.
                self._note_failure(s, err)
                mask[idx] = True
                bad_shards.append(s)
                bad_ranges.extend(
                    getattr(err, "ranges", ())
                    or (DegradedRange(int(uniq[idx[0]]), int(uniq[idx[-1]]),
                                      -1, str(err)),))
                continue
            offs_s, dst_s, prop_s = res
            counts[idx] = np.diff(offs_s)
            dst_parts.append(dst_s)
            prop_parts.append(prop_s)
        dst = (np.concatenate(dst_parts) if dst_parts
               else np.empty(0, np.int64))
        prop = (np.concatenate(prop_parts) if prop_parts
                else np.empty(0, np.float32))
        offs = np.zeros(B + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        out = slice_adjacency(offs, dst, prop, inv, return_props)
        if with_report:
            pos = np.nonzero(mask[inv])[0].astype(np.int64)
            return out, DegradedReport(tuple(dict.fromkeys(bad_shards)),
                                       tuple(bad_ranges), pos)
        return out

    def query_edges_batch(self, us, vs) -> np.ndarray:
        """Batched edge membership — routed by source vertex; pairs whose
        source lives on no shard are absent by definition (False).  Pairs
        owned by a fenced shard, or hitting a mid-read ``StorageError``,
        answer False (degraded-mode: membership unknown => not asserted)."""
        us = np.asarray(us, np.int64).ravel()
        vs = np.asarray(vs, np.int64).ravel()
        if us.shape != vs.shape:
            raise ValueError("us and vs must have the same length")
        if us.size == 0:
            return np.zeros(0, bool)
        per_us, per_pos, n = router.route_queries(self.part, us)
        out = np.zeros(n, bool)
        touched = [s for s, sub_us in enumerate(per_us)
                   if len(sub_us) and self.snaps[s] is not None]
        settled = _run_calls_settled(
            self._pool,
            [(self.snaps[s].query_edges_batch, (per_us[s], vs[per_pos[s]]))
             for s in touched])
        for s, (res, err) in zip(touched, settled):
            if err is not None:
                if not isinstance(err, StorageError):
                    raise err
                self._note_failure(s, err)
                continue
            out[per_pos[s]] = res
        return out

    def degrees_batch(self, vs) -> np.ndarray:
        return np.array([len(n) for n in self.neighbors_batch(vs)], np.int64)

    def edge_set(self) -> set:
        """Union of per-shard live edge sets (verification only — O(E));
        fenced shards contribute nothing."""
        out: set = set()
        for snap in self.snaps:
            if snap is not None:
                out |= snap.edge_set()
        return out

    # -------------------------------------------------------------- lifecycle
    def release(self) -> None:
        if not self._released:
            for snap in self.snaps:
                if snap is not None:
                    snap.release()
            self._released = True

    def __enter__(self) -> "ShardedSnapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class ShardedGraphStore:
    """Mesh-partitioned facade over ``n_shards`` independent ``LSMGraph``s.

    Pass pre-built ``stores`` (e.g. durable, one directory per shard via
    ``open_sharded_store``) or a ``cfg`` to build fresh in-memory shards on
    ``device`` (None: the current CUDA card; raises when there is none).
    Every shard keeps the GLOBAL vertex-id space in its config (its runs
    simply never hold vertices outside its owned range), so per-shard reads
    need no id translation.
    """

    def __init__(self, cfg: Optional[StoreConfig] = None, n_shards: int = 1,
                 *, device=None, stores: Optional[Sequence[LSMGraph]] = None,
                 max_workers: Optional[int] = None, scale_mem: bool = False):
        if stores is not None:
            self.shards = list(stores)
            n_shards = len(self.shards)
            cfg = self.shards[0].cfg
            self.device = self.shards[0].device
        else:
            assert cfg is not None, "need cfg or pre-built stores"
            # Default: every shard keeps ``cfg``'s provisioning (scale-out =
            # more same-sized nodes, aggregate capacity grows with S).
            # scale_mem=True instead sizes each shard's fixed-capacity
            # tiers to its 1/S slice (constant aggregate provisioning).
            shard_cfg = shard_scaled_config(cfg, n_shards) if scale_mem \
                else cfg
            self.device = resolve_device(device)
            self.shards = [LSMGraph(shard_cfg, device=self.device)
                           for _ in range(n_shards)]
        self.cfg = cfg
        self.part = RangePartition.for_vmax(cfg.vmax, n_shards)
        # Coordinator epoch: writes apply to all owner shards under this
        # lock; snapshots collect per-shard taus under it.  Held across the
        # parallel per-shard applies (so a snapshot sees a batch on every
        # owner shard or on none), NOT across reads.
        self._epoch_lock = threading.RLock()
        self._epoch = 0
        # Failure isolation: shard -> reason for every fenced shard.  Guarded
        # by its OWN plain lock, never the epoch RLock — pool worker threads
        # fence mid-apply/mid-read while the coordinator thread holds the
        # epoch lock waiting on those very futures; sharing the (non-
        # reentrant-across-threads) lock would deadlock the fan-out.
        self._health_lock = threading.Lock()
        self._fenced: Dict[int, str] = {}
        # Set by open_sharded_store: per-shard root dirs + open options, the
        # recovery source reopen_shard() needs.  None for in-memory stores.
        self.shard_roots: Optional[List[str]] = None
        self._open_opts: Dict[str, object] = {}
        # Fan-out concurrency: one worker per shard, capped at the cores.
        # A shard's resolve or apply is mostly host work (Python, numpy,
        # kernel launches) broken by device-to-host copies that wait on the
        # card with the GIL released, so one shard's launches overlap
        # another's waits; more threads than cores only thrash the GIL.
        # Every worker launches on the device's default stream.
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers or max(
                1, min(n_shards, os.cpu_count() or 1)),
            thread_name_prefix="shard")
        # Per-shard observability (label cardinality bounded by n_shards):
        # fencing state + ack latency + degraded-range gauges, plus the
        # routed-batch fan-out distribution.  Instruments cached here so
        # the fan-out hot path never touches the registry map.
        self._obs_fanout = obs.REGISTRY.histogram(
            "shard_route_fanout", lo=1.0, hi=1e4)
        self._obs_fence_total = obs.counter("shard_fence_total")
        self._obs_fenced = [obs.gauge("shard_fenced", shard=str(s))
                            for s in range(n_shards)]
        self._obs_ack = [obs.histogram("shard_ack_seconds", shard=str(s))
                         for s in range(n_shards)]
        self._obs_degraded = [
            obs.gauge("shard_degraded_ranges", shard=str(s))
            for s in range(n_shards)]

    @property
    def n_shards(self) -> int:
        return self.part.n_shards

    # ----------------------------------------------------------------- writes
    def insert_edges(self, src, dst, prop=None) -> ShardWriteReceipt:
        return self._apply_routed(src, dst, prop, delete=False)

    def delete_edges(self, src, dst) -> ShardWriteReceipt:
        return self._apply_routed(src, dst, None, delete=True)

    def _apply_routed(self, src, dst, prop, *, delete: bool
                      ) -> ShardWriteReceipt:
        buckets = router.bucket_edge_batches(self.part, src, dst, prop)
        with self._epoch_lock:
            # Backpressure BEFORE any shard applies: a batch touching a
            # fenced shard is rejected whole (nothing lands anywhere), so
            # callers never hold a receipt that is unackable by
            # construction.  Healthy-shard-only batches flow normally.
            with self._health_lock:
                bad = [s for s, b in enumerate(buckets)
                       if b is not None and s in self._fenced]
            if bad:
                raise ShardUnavailable(
                    f"write touches fenced shard(s) {bad}; reopen_shard() "
                    "to heal, then retry the batch", shards=bad)
            self._epoch += 1
            epoch = self._epoch
            touched, calls = [], []
            for s, bucket in enumerate(buckets):
                if bucket is None:
                    continue
                b_src, b_dst, b_prop = bucket
                g = self.shards[s]
                touched.append(s)
                fn = g.delete_edges if delete else g.insert_edges
                args = (b_src, b_dst) if delete else (b_src, b_dst, b_prop)
                calls.append((self._guarded(s, fn), args))
            # _run_calls drains EVERY future before the first error
            # propagates, so the epoch lock never releases with sub-batches
            # still landing (the torn state the epoch protocol forbids).
            # A failed shard leaves the batch partially applied (mirroring
            # the single store's partial-chunk semantics on overflow) but
            # never concurrently in flight.
            seqs = dict(zip(touched, _run_calls(self._pool, calls)))
        if touched:
            self._obs_fanout.observe(len(touched))
        return ShardWriteReceipt(
            epoch, {s: q for s, q in seqs.items() if q is not None})

    def _guarded(self, s: int, fn):
        """Wrap a per-shard call: a typed storage failure fences the shard
        (isolating the blast radius to its vertex range) before the error
        propagates to the coordinator."""
        def run(*args):
            try:
                return fn(*args)
            except (CorruptionError, DurabilityLost) as e:
                self.fence(s, e)
                raise
        return run

    def ack(self, receipt: ShardWriteReceipt) -> None:
        """Await durability of ONE routed batch: per shard, block until that
        shard's WAL fsynced the batch's commit seq (``sync_upto``).  Shards
        untouched by the batch — and their WAL queues — are never waited
        on.  No-op for in-memory shards (empty ``seqs``); safe when racing
        ``close()`` (close fsyncs every WAL, so the inline fallback sees
        the seq already durable).

        A shard whose WAL latched its fail-stop flag (failed fsync) raises
        ``DurabilityLost`` **attributed to that shard** (``e.shard``), and
        the shard is fenced — the other shards' acks complete first (every
        future drains before the error propagates)."""
        _run_calls(self._pool, [(self._ack_one, (s, seq))
                                for s, seq in receipt.seqs.items()])

    def _ack_one(self, s: int, seq: int) -> None:
        t0 = time.perf_counter()
        try:
            self._ack_one_inner(s, seq)
        finally:
            # Failed acks count too: a rising tail here is exactly the
            # backpressure signal the serving front end will read.
            self._obs_ack[s].observe(time.perf_counter() - t0)

    def _ack_one_inner(self, s: int, seq: int) -> None:
        try:
            self.shards[s].ack(seq)
        except DurabilityLost as e:
            self.fence(s, e)
            if e.shard is None:
                raise DurabilityLost(f"shard {s}: {e}", shard=s) from e
            raise
        except CorruptionError as e:
            self.fence(s, e)
            raise
        except OSError as e:
            # The FIRST failed fsync surfaces as the raw OSError (the WAL
            # latches its fail-stop flag as it raises); later calls get the
            # typed DurabilityLost.  Normalize: callers of the sharded ack
            # always see a shard-attributed DurabilityLost.
            self.fence(s, e)
            raise DurabilityLost(f"shard {s}: {e}", shard=s) from e

    # ------------------------------------------------------------------ health
    def fence(self, s: int, err) -> None:
        """Mark shard ``s`` failed: writes touching it are rejected
        (``ShardUnavailable``) and new snapshots skip it (its range reads
        as degraded).  Idempotent; the FIRST error is the recorded cause.

        The fenced map follows the store's publish discipline: mutators
        build a NEW dict under ``_health_lock`` and swap the reference, so
        ``fenced()`` reads the current map with one atomic attribute load —
        reader threads checking shard health mid-fan-out never contend with
        a fence landing from a pool worker."""
        with self._health_lock:
            if int(s) not in self._fenced:
                nxt = dict(self._fenced)
                nxt[int(s)] = f"{type(err).__name__}: {err}"
                self._fenced = nxt
                self._obs_fence_total.inc()
                self._obs_fenced[int(s)].set(1)
                obs.REGISTRY.trace_instant(
                    "shard_fence", shard=str(int(s)),
                    reason=f"{type(err).__name__}: {err}"[:80])

    def fenced(self) -> Dict[int, str]:
        """Snapshot of the fenced-shard map (shard -> reason); lock-free —
        ``fence``/``reopen_shard`` publish a fresh dict instead of mutating
        the one a reader may be iterating."""
        return dict(self._fenced)

    def health_report(self) -> Dict[int, dict]:
        """Per-shard health: ``ok``, ``degraded`` (serving around
        quarantined segment ranges), or ``fenced`` (range unavailable until
        ``reopen_shard``), plus the shard's amplification ratios (write/
        read/space + runs-per-query, ``None`` until the relevant counters
        have data) — the ranking signal a per-shard compaction scheduler
        consumes."""
        fenced = self.fenced()
        report: Dict[int, dict] = {}
        for s, g in enumerate(self.shards):
            lo, hi = self.part.shard_range(s)
            entry: dict = {"range": (int(lo), int(hi) - 1), "status": "ok"}
            if s in fenced:
                entry["status"] = "fenced"
                entry["reason"] = fenced[s]
            else:
                dr = g.degraded_ranges()
                self._obs_degraded[s].set(len(dr))
                if dr:
                    entry["status"] = "degraded"
                    entry["degraded"] = [
                        {"lo": r.lo, "hi": r.hi, "fid": r.fid,
                         "reason": r.reason} for r in dr]
            # Ledgers are built on demand: reopen_shard swaps in a new
            # store (fresh obs label), so a cached ledger would go stale.
            entry["amplification"] = obs.AmplificationLedger(g).ratios()
            report[s] = entry
        return report

    def reopen_shard(self, s: int) -> None:
        """Heal a fenced (or degraded) shard by closing its store and
        re-running crash recovery from its own directory — the WAL +
        manifest + quarantine protocol makes the directory the source of
        truth, so the reopened shard serves exactly its acked writes.
        Unfences ``s`` and bumps the epoch (old receipts for this shard are
        stale by construction).  Durable sharded stores only."""
        s = int(s)
        if not self.shard_roots:
            raise RuntimeError(
                "reopen_shard requires a durable sharded store "
                "(opened via open_sharded_store)")
        from ..storage import open_store
        with self._epoch_lock:
            old = self.shards[s]
            try:
                old.close()
            except (StorageError, OSError):
                pass  # a latched WAL may refuse its final fsync; recovery
                      # reads the on-disk state, not the dying handle
            self.shards[s] = open_store(self.shard_roots[s],
                                        **self._open_opts)
            with self._health_lock:
                if s in self._fenced:
                    nxt = dict(self._fenced)
                    nxt.pop(s, None)
                    self._fenced = nxt
            self._obs_fenced[s].set(0)
            self._epoch += 1

    # ------------------------------------------------------------------ reads
    def snapshot(self) -> ShardedSnapshot:
        with self._epoch_lock:
            fenced = self.fenced()
            snaps: List[Optional[Snapshot]] = []
            for s, g in enumerate(self.shards):
                if s in fenced:
                    snaps.append(None)
                    continue
                try:
                    snaps.append(g.snapshot())
                except StorageError as e:
                    # Pinning itself failed: fence and serve the rest.
                    self.fence(s, e)
                    fenced[s] = f"{type(e).__name__}: {e}"
                    snaps.append(None)
            epoch = self._epoch
        return ShardedSnapshot(self.part, snaps, epoch, self._pool,
                               fenced=fenced, owner=self)

    def sharded_neighbors_batch(self, vs, return_props: bool = False) -> list:
        """One-shot routed batched read (snapshot + resolve + release)."""
        with self.snapshot() as snap:
            return snap.neighbors_batch(vs, return_props=return_props)

    def sharded_query_edges_batch(self, us, vs) -> np.ndarray:
        """One-shot routed batched edge-membership."""
        with self.snapshot() as snap:
            return snap.query_edges_batch(us, vs)

    # ------------------------------------------------------------ maintenance
    def flush_all(self) -> None:
        """Flush every shard's MemGraph (parallel; barrier on completion)."""
        _run_calls(self._pool, [(g.flush_memgraph, ()) for g in self.shards])

    def compact_all(self) -> None:
        """Drain every shard's L0 into L1+ (parallel per-shard compaction —
        the steady-state maintenance a shard scheduler would run between
        ingest bursts; tightens run capacities for the read tier)."""
        _run_calls(self._pool, [(g.compact_l0, ()) for g in self.shards])

    def sync(self) -> None:
        """Global durability barrier over every shard, fsyncing in parallel
        (close-time use; the per-batch path is ``ack``)."""
        _run_calls(self._pool, [(g.sync, ()) for g in self.shards])

    def level_sizes(self) -> List[List[int]]:
        return [g.level_sizes() for g in self.shards]

    def disk_bytes(self) -> int:
        return sum(g.disk_bytes() for g in self.shards)

    def close(self) -> None:
        """Close every shard.  A FENCED shard's close failure (e.g. a
        latched WAL refusing its final fsync) is swallowed — the loss was
        already surfaced when the shard fenced; an unfenced shard's failure
        still propagates (after every sibling closed and the pool drained,
        so nothing leaks)."""
        fenced = self.fenced()
        first_err: Optional[BaseException] = None
        for s, g in enumerate(self.shards):
            try:
                g.close()
            except (StorageError, OSError) as e:
                if s not in fenced and first_err is None:
                    first_err = e
        self._pool.shutdown(wait=True)
        if first_err is not None:
            raise first_err


def _load_shard_meta(root: str, meta_path: str) -> Optional[dict]:
    """Read SHARDS.json; a torn/unparseable meta with no shard directories
    yet (a crash during the very first create, before the atomic rename
    protocol existed or mid-rename on a non-atomic filesystem) is safely
    re-creatable — no shard data can exist without its directory."""
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as f:
            return json.load(f)
    # Only torn CONTENT is re-creatable; a transient read failure (EACCES,
    # EIO) must propagate rather than delete a valid meta.
    except json.JSONDecodeError:
        has_shards = any(
            name.startswith("shard-") for name in os.listdir(root))
        if has_shards:
            raise ValueError(
                f"{root}: unreadable {SHARD_META} but shard directories "
                "exist — refusing to guess the shard count") from None
        os.unlink(meta_path)
        return None


def open_sharded_store(root: str, cfg: Optional[StoreConfig] = None, *,
                       device=None, n_shards: Optional[int] = None,
                       wal_sync: str = "batch",
                       wal_sync_interval: float = 0.05,
                       wal_retain: int = 2,
                       on_corruption: str = "degrade",
                       scrub_interval: Optional[float] = None,
                       scale_mem: bool = False) -> ShardedGraphStore:
    """Open (or create) a durable sharded store rooted at ``root``.

    Layout: ``root/SHARDS.json`` records the shard count; each shard is a
    full durable store directory (own WAL + segments + manifest) under
    ``root/shard-<s>/``.  Reopen recovers every shard independently —
    crash recovery composes because shards share nothing.  Every shard
    opens on ``device`` (None: the current CUDA card; raises when there is
    none), and ``reopen_shard`` recovers a shard onto the same device.
    """
    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    meta_path = os.path.join(root, SHARD_META)
    meta = _load_shard_meta(root, meta_path)
    write_meta = meta is None
    pre_existing: List[str] = []
    if meta is not None:
        if n_shards is not None and n_shards != meta["n_shards"]:
            raise ValueError(
                f"{root} holds {meta['n_shards']} shards; asked for "
                f"{n_shards} (resharding is not supported yet)")
        n_shards = meta["n_shards"]
    else:
        # No meta.  Shard dirs present mean a crash before the meta landed
        # (it is written LAST): heal — no write can have been acknowledged
        # before open_sharded_store returned, so the layout is completable.
        pre_existing = [name for name in os.listdir(root)
                        if name.startswith("shard-")]
        # A crashed parallel create can leave GAP-numbered dirs (the pool
        # creates them concurrently): infer the count from the highest
        # index so every surviving dir is opened, never orphaned.
        n_found = 1 + max(
            (int(name.split("-", 1)[1]) for name in pre_existing),
            default=-1)
        if n_found and n_shards is None:
            n_shards = n_found           # no-arg reopen: adopt what exists
        elif n_found and n_shards < n_found:
            raise ValueError(
                f"{root} holds {n_found} shard dirs; asked for {n_shards}")
        elif n_shards is None:
            raise ValueError(f"{root}: fresh directory needs n_shards")
        elif cfg is None and not pre_existing:
            raise ValueError(f"{root}: fresh directory needs cfg")
    from ..storage import open_store
    shard_cfg = cfg
    if cfg is not None and scale_mem:
        shard_cfg = shard_scaled_config(cfg, n_shards)
    # Shards share nothing (own dir, WAL, manifest), so open/recover them in
    # parallel: restart time tracks the largest shard, not the sum.  Every
    # successfully-opened store is closed if ANY sibling open fails — no
    # leaked WAL fds / fsync threads on a partially-corrupt layout.
    with ThreadPoolExecutor(
            max_workers=max(1, min(n_shards, os.cpu_count() or 1))) as pool:
        futs = [pool.submit(open_store,
                            os.path.join(root, SHARD_DIR_FMT % s), shard_cfg,
                            device=device, wal_sync=wal_sync,
                            wal_sync_interval=wal_sync_interval,
                            wal_retain=wal_retain,
                            on_corruption=on_corruption,
                            scrub_interval=scrub_interval)
                for s in range(n_shards)]
        stores = []
        first_err: Optional[BaseException] = None
        for f in futs:
            try:
                stores.append(f.result())
            except BaseException as e:
                if first_err is None:
                    first_err = e
        if first_err is not None:
            for g in stores:
                g.close()
            raise first_err
    if write_meta and pre_existing and n_shards != len(pre_existing):
        # Completing a half-created layout to a LARGER count is only sound
        # while the pre-existing shards are empty — growing n_shards
        # rewires the partition, so data written under the old count would
        # silently change owners.  (A genuine crashed create has no data:
        # the meta lands before open_sharded_store ever returns.)
        pre_idx = sorted(int(name.split("-", 1)[1]) for name in pre_existing)
        if any(stores[i].tau > 0 for i in pre_idx if i < len(stores)):
            for g in stores:
                g.close()
            # Remove the fresh (just-created, empty by construction) dirs
            # so the refusal leaves the on-disk layout exactly as found —
            # a later no-arg adopt must see the data-bearing count.
            for s in range(n_shards):
                name = SHARD_DIR_FMT % s
                if name not in pre_existing:
                    shutil.rmtree(os.path.join(root, name),
                                  ignore_errors=True)
            raise ValueError(
                f"{root}: meta lost but existing shards hold data; reopen "
                "without n_shards to adopt the on-disk layout")
    if write_meta:
        # Meta lands LAST and crash-atomically (tmp + fsync + rename + dir
        # fsync): every shard dir/manifest it names already exists, so a
        # reopen either sees the full layout or heals from the dirs above.
        tmp = meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"n_shards": n_shards, "format": 1}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, meta_path)
        fsutil.fsync_dir(root)
    # Shard configs keep the GLOBAL vmax, so the partition (derived from
    # stores[0].cfg at reopen) covers the original vertex-id space.
    sharded = ShardedGraphStore(stores=stores)
    # Remember where each shard lives + how it was opened: reopen_shard()
    # heals a fenced member by re-running recovery with the same options.
    sharded.shard_roots = [os.path.join(root, SHARD_DIR_FMT % s)
                           for s in range(n_shards)]
    sharded._open_opts = dict(
        device=device, wal_sync=wal_sync, wal_sync_interval=wal_sync_interval,
        wal_retain=wal_retain, on_corruption=on_corruption,
        scrub_interval=scrub_interval)
    return sharded


__all__ = ["DegradedReport", "ShardUnavailable", "ShardWriteReceipt",
           "ShardedGraphStore", "ShardedSnapshot", "open_sharded_store"]
