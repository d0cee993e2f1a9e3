"""LSMGraph store facade (paper §3.2 workflow, §4.2 multi-level CSR).

The port of ``repro.core.store``'s in-memory store:

  write path:   insert/delete batches -> MemGraph (double-buffered) ->
                flush to an L0 CSR run -> whole-L0 compaction into L1 ->
                partial (per-segment-file) compaction L_i -> L_{i+1}
  read path:    Snapshot pins one published ``StoreState``; a batched read
                ranks the query vector into the state's shared read spine
                (every sealed record, tournament-merged once into (src,
                dst, ts) order by the merge-path kernel), gates (run, query)
                pairs with the multi-level index and the presence-filter
                kernel, annihilates per (src, dst), and lets the active
                MemGraph's records override the sealed winners.

Every tensor lives on the store's device.  Concurrency follows the
reference: all mutable state is one immutable, atomically published
``StoreState``; writers build the next one off to the side and swap it in
under a short host-only commit lock; snapshots take no writer lock.

A store built with a ``durability`` engine (``repro_torch.storage``,
through ``open_store``) logs every batch to the WAL before it enters the
MemGraph, writes segment files at flush and compaction, and reloads
evicted runs from disk, the cold ones through ``prefetch_pool``.  Every
thread the store and the engine start keeps the device's default stream.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import csr, filters, index as mlindex, memgraph as mg_mod
from .. import obs
from ..kernels import ops as kops
from ..kernels.merge import MERGE_STATS as _MERGE_STATS, to_device
from .types import (BYTES_PER_EDGE, BYTES_PER_PROP, INVALID_VID, EdgeBatch,
                    IOCounters, MemGraphState, RunFile, StoreConfig, Version,
                    resolve_device, scalar)
from .versions import VersionChain

_I32 = torch.int32
_REC_BYTES = BYTES_PER_EDGE + BYTES_PER_PROP


def _read_filters_enabled() -> bool:
    """Per-run presence-filter gating on the read path, read PER RESOLVE so
    ``LSMG_READ_FILTERS=0`` can flip it mid-process.  Filters only ever
    remove provably-absent (run, query) pairs, so results are byte-identical
    either way — 0 is an ablation lever."""
    return os.environ.get("LSMG_READ_FILTERS", "1") not in (
        "0", "false", "False")


# 0 disables the tournament-merged read spine entirely: every resolve then
# takes the legacy concat-then-lexsort path (an escape hatch, read once at
# import as in the reference).
_READ_TOURNAMENT_MAX_K = int(os.environ.get("LSMG_READ_TOURNAMENT_K", "8"))


# Shared background pool for cold-segment loads: prefetch submissions from
# the read path overlap disk reads and uploads with the foreground's device
# dispatch.  Process-wide and created lazily, so pure in-memory stores never
# spawn threads.  Narrow by default: a segment load is partly host work
# (CRC, copy), and one background loader plus the foreground thread already
# forms the two-stage pipeline.
_PREFETCH_WORKERS = int(os.environ.get(
    "LSMG_PREFETCH_WORKERS",
    str(max(1, min(4, (os.cpu_count() or 2) - 1)))))
_PREFETCH_POOL: Optional[ThreadPoolExecutor] = None
_PREFETCH_POOL_LOCK = threading.Lock()


def prefetch_pool() -> ThreadPoolExecutor:
    global _PREFETCH_POOL
    if _PREFETCH_POOL is None:
        with _PREFETCH_POOL_LOCK:
            if _PREFETCH_POOL is None:
                _PREFETCH_POOL = ThreadPoolExecutor(
                    max_workers=_PREFETCH_WORKERS,
                    thread_name_prefix="lsm-prefetch")
    return _PREFETCH_POOL


# Per-process store ordinal for metric labels (the port's own registry, so
# no collision with the JAX package's stores in one process).
_STORE_ORDINAL = itertools.count()


@dataclasses.dataclass(frozen=True, eq=False)
class StoreState:
    """One immutable, atomically-published store state.

    A commit builds every field off to the side and installs the next
    ``StoreState`` with a single reference swap, so a reader that grabs
    ``store._state`` holds a complete, internally-consistent view forever.
    ``runs_by_fid`` is never mutated after publication.  ``spine`` is the
    state's shared, lazily-built read backbone: per-batch writes reuse the
    previous handle, sealed-membership changes publish a fresh one."""

    epoch: int
    tau: int
    mem: MemGraphState
    mem_id: int
    mem_full: Optional[MemGraphState]
    mem_full_id: Optional[int]
    levels: Tuple[Tuple[RunFile, ...], ...]
    index: mlindex.IndexState
    runs_by_fid: Dict[int, RunFile]
    version: Version
    degraded: tuple
    spine: "_SpineHandle"


@dataclasses.dataclass(frozen=True, eq=False)
class _RunSpine:
    """The merged SEALED-RUN portion of a read spine: every L0/L1+ run's
    records tournament-merged into one (src, dst, ts)-ordered stream, with
    ``rid`` = the record's position in ``runs``.  ``cols`` are fitted to the
    half-step quantized capacity; valid records form a sorted
    ``total``-length prefix (pads carry src == INVALID_VID)."""

    fids: frozenset
    runs: Tuple[Tuple[RunFile, int], ...]   # rid order; col < 0 means L0
    cols: tuple                             # (src,dst,ts,rid,marker,prop)
    total: int


def _pad_backbone(src, dst, ts, rid, marker, prop, pad: int):
    def p(x, fill):
        return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                        device=x.device)])
    return (p(src, INVALID_VID), p(dst, 0), p(ts, 0), p(rid, -1),
            p(marker, False), p(prop, 0.0))


def _fit_spine_cols(cols, total: int):
    """Pad or trim merged spine columns to the half-step quantized capacity
    (valid records are a sorted prefix, so trimming only drops pads)."""
    cap = csr.quantize_cap(total, half_steps=True)
    n = int(cols[0].shape[0])
    if n < cap:
        return _pad_backbone(*cols, pad=cap - n)
    if n > cap:
        return tuple(c[:cap] for c in cols)
    return tuple(cols)


def _spine_run_streams(runs, rid_base: int = 0, lead=None):
    """Every run as a backbone stream (src, dst, ts, rid, marker, prop),
    the streams laid end to end at full capacity, pads included, one
    buffer a column; ``lead``, an already merged stream, goes first.
    Returns (columns, capacities) for ``merge_laid_out``.

    Each run is (src, dst, ts)-ordered by construction and its pad slots
    carry src == INVALID_VID, so no stream is sorted.  ``src`` is
    ``csr.expand_src`` of every run at once: one ``searchsorted`` of the
    global slot index over every run's ``voff[1:]`` shifted to the run's
    first slot (the runs' ranges do not overlap, so each slot finds its
    own run's vertex), and ``rid`` one ``repeat_interleave`` with its
    output size given, so the host never waits on the card.  Cold
    (evicted) runs are all put on the prefetch pool first, so their loads
    overlap each other and the foreground's."""
    pool = None
    for rf, _col in runs:
        if rf.arrays is None:
            pool = pool or prefetch_pool()
            rf.prefetch(pool)
    arrays = [rf.ensure_loaded() for rf, _col in runs]
    dev = arrays[0].dst.device
    ecap = np.array([a.ecap for a in arrays], np.int64)
    vcap = np.array([a.vcap for a in arrays], np.int64)
    lead_n = 0 if lead is None else int(lead[0].shape[0])
    eoff = lead_n + np.cumsum(ecap) - ecap
    voff0 = np.cumsum(vcap) - vcap
    n_e, n_v = int(ecap.sum()), int(vcap.sum())
    tab = to_device(np.concatenate([ecap, vcap, eoff, voff0]), dev)
    ecap_t, vcap_t, eoff_t, voff0_t = tab.split(len(arrays))
    run = torch.repeat_interleave(
        torch.arange(len(arrays), device=dev), ecap_t, output_size=n_e)
    slot = torch.arange(lead_n, lead_n + n_e, device=dev)
    ends = torch.cat([a.voff[1:] for a in arrays]).long() + \
        torch.repeat_interleave(eoff_t, vcap_t, output_size=n_v)
    j = torch.minimum(torch.searchsorted(ends, slot, right=True),
                      (voff0_t + vcap_t - 1)[run])
    ne = torch.stack([a.ne for a in arrays]).long()
    src = torch.where(slot - eoff_t[run] < ne[run],
                      torch.cat([a.vkeys for a in arrays])[j],
                      INVALID_VID).to(_I32)
    cols = [src, torch.cat([a.dst for a in arrays]),
            torch.cat([a.ts for a in arrays]), (run + rid_base).to(_I32),
            torch.cat([a.marker for a in arrays]),
            torch.cat([a.prop for a in arrays])]
    caps = ecap.tolist()
    if lead is not None:
        cols = [torch.cat([x, c]) for x, c in zip(lead, cols)]
        caps = [lead_n] + caps
    return tuple(cols), caps


def _empty_cols(device):
    z = torch.zeros((0,), dtype=_I32, device=device)
    return (z, z, z, z, torch.zeros((0,), dtype=torch.bool, device=device),
            torch.zeros((0,), dtype=torch.float32, device=device))


def _build_run_spine(runs, device) -> _RunSpine:
    """From-scratch merge of a sealed run set (the cold-cache path)."""
    runs = tuple(runs)
    if not runs:
        return _RunSpine(frozenset(), (), _empty_cols(device), 0)
    total = sum(rf.ne for rf, _col in runs)
    cols = kops.merge_laid_out(*_spine_run_streams(runs))
    _MERGE_STATS.bump("spine_build")
    return _RunSpine(frozenset(rf.fid for rf, _col in runs), runs,
                     _fit_spine_cols(cols, total), total)


def _filter_remap_spine(src, dst, ts, rid, marker, prop, rid_map,
                        out_cap: int):
    """Compress a spine's retained records (rid_map[rid] >= 0) into a dense
    sorted prefix with remapped rids — the kept side of a splice.  The
    gather preserves order, so the result is still (src, dst, ts)-sorted."""
    rid_c = rid.clamp(0, rid_map.shape[0] - 1).long()
    new_rid = torch.where(rid >= 0, rid_map[rid_c], -1)
    keep = (src != INVALID_VID) & (new_rid >= 0)
    idx = torch.nonzero(keep).reshape(-1)[:out_cap]
    cols = (src[idx], dst[idx], ts[idx], new_rid[idx].to(_I32), marker[idx],
            prop[idx])
    return _pad_backbone(*cols, pad=out_cap - idx.shape[0])


def _splice_run_spine(base: _RunSpine, runs) -> _RunSpine:
    """Incremental spine invalidation: runs surviving from ``base`` keep
    their already-merged relative order (one compress + rid remap); only
    the ADDED runs' streams enter a fresh tournament against that retained
    stream.  Every record carries a globally-unique ts, so the merged
    order is independent of merge-tree shape: a spliced spine's valid
    prefix is byte-identical to a from-scratch build's (rid numbering
    aside)."""
    runs = tuple(runs)
    new_fids = {rf.fid for rf, _col in runs}
    kept = [(rf, col) for (rf, col) in base.runs if rf.fid in new_fids]
    kept_fids = {rf.fid for rf, _col in kept}
    added = [(rf, col) for (rf, col) in runs if rf.fid not in kept_fids]
    pos = {rf.fid: i for i, (rf, _col) in enumerate(base.runs)}
    rid_map = np.full(max(len(base.runs), 1), -1, np.int32)
    for new_i, (rf, _col) in enumerate(kept):
        rid_map[pos[rf.fid]] = new_i
    retained_total = sum(rf.ne for rf, _col in kept)
    out_cap = csr.quantize_cap(max(retained_total, 1))
    dev = base.cols[0].device
    retained = _filter_remap_spine(
        *base.cols, torch.from_numpy(rid_map).to(dev), out_cap=out_cap)
    if added:
        cols = kops.merge_laid_out(*_spine_run_streams(
            added, rid_base=len(kept), lead=retained))
    else:
        cols = retained
    total = retained_total + sum(rf.ne for rf, _col in added)
    _MERGE_STATS.bump("spine_splice")
    return _RunSpine(frozenset(new_fids), tuple(kept + added),
                     _fit_spine_cols(cols, total), total)


class _SpineCache:
    """Store-level cache of recently merged run spines, keyed by fid set:
    identical set -> reuse; overlapping set -> splice the delta into the
    cached spine with the largest overlap; disjoint/cold -> build.  Two
    slots (newest first), so a snapshot pinned just before a commit still
    hits the previous sealed epoch's spine.  Guarded by its own mutex —
    never a store writer lock."""

    def __init__(self, device) -> None:
        self._mu = threading.Lock()
        self._slots: List[_RunSpine] = []   # newest-first, len <= 2
        self._device = device

    def get(self, runs) -> _RunSpine:
        runs = tuple(runs)
        fids = frozenset(rf.fid for rf, _col in runs)
        with self._mu:
            for cached in self._slots:
                if cached.fids == fids:
                    _MERGE_STATS.bump("spine_reuse")
                    return cached
            base: Optional[_RunSpine] = None
            best = 0
            if fids:
                for cached in self._slots:
                    overlap = len(cached.fids & fids)
                    if overlap > best:
                        best, base = overlap, cached
            if base is not None:
                spine = _splice_run_spine(base, runs)
            else:
                spine = _build_run_spine(runs, self._device)
            if fids or not self._slots:
                self._slots = ([spine] + self._slots)[:2]
            return spine


class _SpineHandle:
    """Lazily-built read backbone shared by EVERY snapshot at one sealed
    epoch, built at most once under a handle-local latch that no writer
    takes, and assigned only after full construction."""

    __slots__ = ("_mu", "_bb")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._bb: Optional["_ReadBackbone"] = None

    def ready(self) -> bool:
        return self._bb is not None

    def get(self, state: StoreState, store: "LSMGraph") -> "_ReadBackbone":
        bb = self._bb
        if bb is None:
            with self._mu:
                bb = self._bb
                if bb is None:
                    with obs.REGISTRY.span("read_spine_build",
                                           store=store.obs_label):
                        bb = _build_state_backbone(state, store)
                        if bb.src.is_cuda:
                            # Once per sealed epoch: the span then times
                            # the merge itself, not just its enqueue.
                            torch.cuda.synchronize(bb.src.device)
                    self._bb = bb
        return bb


@dataclasses.dataclass
class _ReadBackbone:
    """The merged read spine of one sealed epoch: every sealed record in
    global (src, dst, ts) order, ``rid`` = source run (-1 = the sealed
    MemGraph tier, always visible).  ``run_fid``/``run_col`` describe the
    runs, in rid order, for the vectorized visibility test (col < 0 means
    L0), and
    ``fwords``/``foffs``/``fmasks`` are the runs' presence filters in the
    ragged layout of ``kernels.presence`` (None when no run has one)."""

    src: torch.Tensor
    dst: torch.Tensor
    ts: torch.Tensor
    rid: torch.Tensor
    marker: torch.Tensor
    prop: torch.Tensor
    run_fid: torch.Tensor
    run_col: torch.Tensor
    fwords: Optional[torch.Tensor] = None
    foffs: Optional[torch.Tensor] = None
    fmasks: Optional[torch.Tensor] = None


def _build_state_backbone(state: StoreState, store: "LSMGraph"):
    """Merge the state's SEALED tiers (L0/L1+ runs via the store's spine
    cache, plus the rotated-out full MemGraph) into the shared read spine.
    The ACTIVE MemGraph is deliberately absent: it is resolved per query
    batch and, by ts tier dominance (every active record is newer than
    every sealed one), its visible (src, dst) pairs suppress the sealed
    winners — so per-batch writes never invalidate this spine."""
    bad = {r.fid for r in state.degraded}
    runs: List[Tuple[RunFile, int]] = []
    for rf in state.levels[0]:
        if rf.nv > 0 and rf.fid not in bad:
            runs.append((rf, -1))
    for col, lvl in enumerate(state.levels[1:]):
        for rf in lvl:
            if rf.nv > 0 and rf.fid not in bad:
                runs.append((rf, col))
    spine = store._spine_cache.get(runs)
    cols, total = spine.cols, spine.total
    mem_full = state.mem_full
    if mem_full is not None and int(mem_full.ne) != 0:
        # The sealed-tier handoff: the frozen full MemGraph rides the spine
        # (rid = -1, always visible) until its flush commit retires it.
        total = total + int(mem_full.ne)
        mem_stream = mg_mod.backbone_stream(mem_full)
        if spine.total == 0:
            cols = _fit_spine_cols(mem_stream, total)
        else:
            cols = _fit_spine_cols(
                kops.tournament_merge([mem_stream, tuple(cols)]), total)
    dev = store.device
    fwords, foffs, fmasks = _stack_presence(spine.runs, dev)
    return _ReadBackbone(
        *cols,
        run_fid=torch.tensor([rf.fid for rf, _c in spine.runs], dtype=_I32,
                             device=dev),
        run_col=torch.tensor([c for _rf, c in spine.runs],
                             dtype=torch.int64, device=dev),
        fwords=fwords, foffs=foffs, fmasks=fmasks)


def _stack_presence(runs, device):
    """The runs' presence filters, ragged: (int32 words of every run back to
    back, int64 first word per run, int32 mbits - 1 per run).  A run
    WITHOUT a filter gets FILTER_MIN_BITS of all-ones words — every probe
    hits, so it degrades to "always maybe" exactly like the scalar path's
    ``presence is None`` case.  (The JAX package pads every row to the
    widest filter; the hit matrix is the same, without a [R, W_max] block
    that a large L0 run would blow up.)"""
    filts = [rf.presence for rf, _col in runs]
    if not filts or all(f is None for f in filts):
        return None, None, None
    ones = np.full(filters.FILTER_MIN_BITS // 32, 0xFFFFFFFF, np.uint32)
    rows = [ones if f is None else f.words for f in filts]
    masks = np.array([filters.FILTER_MIN_BITS - 1 if f is None
                      else f.mbits - 1 for f in filts], np.int64)
    offs = np.zeros(len(rows), np.int64)
    offs[1:] = np.cumsum([r.shape[0] for r in rows])[:-1]
    words = np.concatenate(rows).view(np.int32)
    return (torch.from_numpy(words).to(device),
            torch.from_numpy(offs).to(device),
            torch.from_numpy(masks.astype(np.int32)).to(device))


class LSMGraph:
    """Dynamic graph store: LSM-tree level structure over CSR runs.

    ``device``: where every tensor of the store lives; None means the
    current CUDA card (and raises when there is none).

    Lock roster (as in the reference): ``_lock`` is the short host-only
    commit lock around ts assignment and the state swap; ``_write_lock``
    serializes MemGraph writers; ``_flush_lock`` serializes flush pipelines
    and level/index change; ``_compact_lock`` serializes compactions;
    ``_fid_lock`` guards fid allocation.  Order: ``_compact_lock`` >
    ``_flush_lock`` > ``_write_lock`` > ``_lock``."""

    def __init__(self, cfg: StoreConfig, device=None, durability=None,
                 obs_label: Optional[str] = None):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        # Optional durability engine (repro_torch.storage.DurableStorage):
        # WAL / segment-file / manifest hooks.  None = in-memory store.
        self.durability = durability
        self._lock = threading.RLock()
        self._write_lock = threading.RLock()
        self._flush_lock = threading.RLock()
        self._compact_lock = threading.RLock()
        self._fid_lock = threading.Lock()
        self.versions = VersionChain()
        self.obs_label = obs_label or f"s{next(_STORE_ORDINAL)}"
        self.io = IOCounters().bind(store=self.obs_label)
        self._obs_apply = obs.histogram("store_apply_seconds",
                                        store=self.obs_label)
        self._obs_resolve = obs.histogram("read_resolve_seconds",
                                          store=self.obs_label)
        self._obs_publish = obs.counter("store_state_publish_total",
                                        store=self.obs_label)
        self._obs_ingest_bytes = obs.counter("store_logical_ingest_bytes",
                                             store=self.obs_label)
        self._obs_edges_ins = obs.counter("store_edges_inserted_total",
                                          store=self.obs_label)
        self._obs_edges_del = obs.counter("store_edges_deleted_total",
                                          store=self.obs_label)
        self._obs_read_queries = obs.counter("read_queries_total",
                                             store=self.obs_label)
        self._obs_read_probes = obs.counter("read_runs_probed_total",
                                            store=self.obs_label)
        self._obs_read_returned = obs.counter("read_returned_bytes",
                                              store=self.obs_label)
        self._obs_filter_checked = obs.counter("read_filter_checked_total",
                                               store=self.obs_label)
        self._obs_filter_skipped = obs.counter("read_filter_skipped_total",
                                               store=self.obs_label)
        self._obs_filter_fp = obs.counter(
            "read_filter_false_positive_total", store=self.obs_label)
        self.on_flush_needed = None  # callback for the concurrent wrapper
        self._ts = 0
        self._next_fid = 0
        self._next_mem_id = 1
        self._spine_cache = _SpineCache(self.device)
        version = self.versions.publish((0,), (), 0)
        self._state = StoreState(
            epoch=0, tau=0, mem=mg_mod.empty_memgraph(cfg, self.device),
            mem_id=0, mem_full=None, mem_full_id=None,
            levels=tuple(() for _ in range(cfg.n_levels)),
            index=mlindex.empty_index(cfg.vmax, cfg.n_levels, self.device),
            runs_by_fid={}, version=version, degraded=(),
            spine=_SpineHandle())
        if durability is not None:
            durability.attach(self)

    # ------------------------------------------------------------------ util
    @property
    def mem(self) -> MemGraphState:
        return self._state.mem

    @property
    def levels(self) -> Tuple[Tuple[RunFile, ...], ...]:
        return self._state.levels

    @property
    def index(self) -> mlindex.IndexState:
        return self._state.index

    @property
    def runs_by_fid(self) -> Dict[int, RunFile]:
        return self._state.runs_by_fid

    @property
    def tau(self) -> int:
        return self._state.tau

    def _swap_state(self, **fields) -> StoreState:
        """Install the next StoreState.  Caller holds ``_lock``; every
        expensive value is computed before entering it."""
        cur = self._state
        nxt = dataclasses.replace(cur, epoch=cur.epoch + 1, **fields)
        self._state = nxt
        self._obs_publish.inc()
        return nxt

    def _obs_update_level_gauges(self, levels) -> None:
        """Refresh the L0-depth / runs-per-level gauges after a membership
        commit; a level that just emptied gets its series removed."""
        reg = obs.REGISTRY
        if levels[0]:
            obs.gauge("store_l0_depth", store=self.obs_label).set(
                len(levels[0]))
        else:
            reg.remove("store_l0_depth", store=self.obs_label)
        for i, lvl in enumerate(levels):
            if lvl:
                obs.gauge("store_level_runs", store=self.obs_label,
                          level=str(i)).set(len(lvl))
            else:
                reg.remove("store_level_runs", store=self.obs_label,
                           level=str(i))

    def note_health_change(self) -> None:
        """Republish after a quarantine or heal: the next state carries the
        live degraded set and a FRESH spine handle, so spines built from
        here on exclude (or re-include) the affected segments.  Called by
        the storage engine off the serving path."""
        deg = self.degraded_ranges()
        with self._lock:
            self._swap_state(degraded=deg, spine=_SpineHandle())

    def drop_read_spine(self) -> None:
        """Forget every cached merged read view: reset the splice cache and
        publish a fresh spine handle, so the next snapshot read rebuilds
        the spine from the run arrays.  Pairs with the storage engine's
        segment eviction: without it the state's spine would keep serving
        (and holding device memory for) merged copies of evicted runs."""
        self._spine_cache = _SpineCache(self.device)
        with self._lock:
            self._swap_state(spine=_SpineHandle())

    def _new_fid(self) -> int:
        with self._fid_lock:
            f = self._next_fid
            self._next_fid += 1
            return f

    def n_edges_cached(self) -> int:
        return int(self._state.mem.ne)

    # ----------------------------------------------------------------- write
    def insert_edges(self, src, dst, prop=None) -> Optional[int]:
        """Insert a batch (chunked by ``batch_cap``).  Durable stores return
        the WAL commit seq of the last appended record (awaitable via
        ``ack``); in-memory: None."""
        return self._apply(src, dst, prop, delete=False)

    def delete_edges(self, src, dst) -> Optional[int]:
        """Deletion = tombstone record (annihilates at read & compaction).
        Returns the WAL commit seq like ``insert_edges``."""
        return self._apply(src, dst, None, delete=True)

    def _apply_no_flush(self, src, dst, prop, *, delete: bool) -> Optional[int]:
        """Ingest without the inline flush trigger — the concurrent wrapper's
        background compactor owns flush/compaction."""
        return self._apply(src, dst, prop, delete=delete, allow_flush=False)

    def _apply(self, src, dst, prop, *, delete: bool,
               allow_flush: bool = True) -> Optional[int]:
        src = np.asarray(src, np.int32).ravel()
        dst = np.asarray(dst, np.int32).ravel()
        if prop is None:
            prop = np.zeros_like(src, dtype=np.float32)
        else:
            prop = np.asarray(prop, np.float32).ravel()
        bc = self.cfg.batch_cap
        commit_seq: Optional[int] = None
        for off in range(0, len(src), bc):
            s, d, p = src[off:off + bc], dst[off:off + bc], prop[off:off + bc]
            n = len(s)
            if not allow_flush:
                # Backstop for the concurrent wrapper: if the background
                # compactor lags and the cache hits hard capacity, wait.
                deadline = time.time() + 60.0
                while self._mem_hard_full() and time.time() < deadline:
                    if self.on_flush_needed is not None:
                        self.on_flush_needed()
                    time.sleep(0.001)
                if self._mem_hard_full():
                    raise RuntimeError(
                        "background flush did not relieve a hard-full "
                        "MemGraph within 60 s")
            marker = np.full(n, delete, bool)
            t_chunk = time.perf_counter()
            with self._write_lock:
                st = self._state
                with self._lock:
                    ts = np.arange(self._ts, self._ts + n, dtype=np.int32)
                    self._ts += n
                    if self.durability is not None:
                        # WAL-before-MemGraph: the batch is logged before it
                        # can become readable; fsync group-commits off-path.
                        commit_seq = self.durability.on_apply(
                            s, d, ts, marker, p)
                # Device-side insert OUTSIDE the commit lock; only the
                # reference swap below re-enters _lock.
                new_mem, ok = self._insert_batch(st.mem, s, d, ts, marker, p)
                if not ok:
                    if self.durability is not None:
                        # Keep WAL == acknowledged state: replay must not
                        # resurrect a batch whose insert raised.
                        self.durability.on_apply_abort(int(ts[0]) if n else -1)
                    raise RuntimeError(
                        "MemGraph capacity/hash overflow — raise mem caps")
                if self.cfg.memcache_mode == "array_only":
                    self.io.flush_write += n  # nominal movement charge
                with self._lock:
                    self._swap_state(mem=new_mem, tau=self._ts)
            self._obs_apply.observe(time.perf_counter() - t_chunk)
            self._obs_ingest_bytes.inc(n * _REC_BYTES)
            (self._obs_edges_del if delete else self._obs_edges_ins).inc(n)
            if allow_flush and mg_mod.memgraph_should_flush(
                    self._state.mem, self.cfg):
                self.flush_memgraph()
        return commit_seq

    def _insert_batch(self, mem: MemGraphState, s, d, t, m, p):
        """Pad one <= batch_cap chunk into an EdgeBatch on the device and
        insert it into the given MemGraph tier: ``(new_mem, ok)``."""
        bc, dev = self.cfg.batch_cap, self.device

        def up(a):
            return torch.from_numpy(_pad(a, bc)).to(dev, copy=True)

        batch = EdgeBatch(src=up(s), dst=up(d), ts=up(t), prop=up(p),
                          marker=up(m), n=scalar(len(s), dev))
        new_mem, ok = mg_mod.insert_batch(mem, batch,
                                          mode=self.cfg.memcache_mode)
        return new_mem, bool(ok)

    def _ingest_replay(self, src, dst, ts, marker, prop) -> None:
        """Recovery-only ingest: re-insert WAL records with their ORIGINAL
        timestamps (no WAL re-append — the records are already on disk).
        Flushes triggered here follow the normal durable path, advancing the
        WAL floor as they land."""
        src = np.asarray(src, np.int32).ravel()
        dst = np.asarray(dst, np.int32).ravel()
        ts = np.asarray(ts, np.int32).ravel()
        marker = np.asarray(marker, bool).ravel()
        prop = np.asarray(prop, np.float32).ravel()
        bc = self.cfg.batch_cap
        for off in range(0, len(src), bc):
            s, d = src[off:off + bc], dst[off:off + bc]
            t, m, p = ts[off:off + bc], marker[off:off + bc], prop[off:off + bc]
            with self._write_lock:
                st = self._state
                with self._lock:
                    self._ts = max(self._ts, int(t[-1]) + 1)
                new_mem, ok = self._insert_batch(st.mem, s, d, t, m, p)
                if not ok:
                    raise RuntimeError(
                        "MemGraph overflow during WAL replay — raise mem caps")
                with self._lock:
                    self._swap_state(mem=new_mem, tau=self._ts)
            n, nd = len(s), int(np.count_nonzero(m))
            self._obs_ingest_bytes.inc(n * _REC_BYTES)
            self._obs_edges_del.inc(nd)
            self._obs_edges_ins.inc(n - nd)
            if mg_mod.memgraph_should_flush(self._state.mem, self.cfg):
                self.flush_memgraph()

    def _mem_hard_full(self) -> bool:
        mem = self._state.mem
        ovf_n, n_rows = (int(x) for x in
                         torch.stack([mem.ovf_n, mem.n_rows]).tolist())
        return (ovf_n >= self.cfg.ovf_cap - self.cfg.batch_cap
                or n_rows >= self.cfg.n_segments - self.cfg.batch_cap
                or n_rows >= int(0.72 * self.cfg.hash_slots))

    # ----------------------------------------------------------------- flush
    def flush_memgraph(self) -> Optional[RunFile]:
        """MemGraph -> L0 CSR run, written directly without compaction; then
        maybe L0 compaction.  The rotate and the commit are each ONE
        published state swap; both install fresh spine handles."""
        with self._flush_lock:
            if int(self._state.mem.ne) == 0:
                return None
            with obs.REGISTRY.span("store_flush", store=self.obs_label):
                fresh = mg_mod.empty_memgraph(self.cfg, self.device)
                deg = self.degraded_ranges()
                with self._write_lock:
                    with self._lock:
                        st = self._state
                        if int(st.mem.ne) == 0:
                            return None
                        mem_id = self._next_mem_id
                        self._next_mem_id += 1
                        wal_floor = self._ts
                        version = self.versions.publish(
                            (mem_id, st.mem_id),
                            tuple(r.fid for r in st.levels[0]), self._ts)
                        # Rotate double buffer: full MemGraph stays readable.
                        self._swap_state(
                            mem=fresh, mem_id=mem_id, mem_full=st.mem,
                            mem_full_id=st.mem_id, version=version,
                            degraded=deg, spine=_SpineHandle())
                        mem_full = st.mem
                    if self.durability is not None:
                        self.durability.on_flush_rotate(wal_floor)
                obs.REGISTRY.trace_instant("store_flush_rotate",
                                           store=self.obs_label)
                src, dst, ts, marker, prop, n = mg_mod.flush_arrays(mem_full)
                cap = csr.quantize_cap(int(n))
                run = csr.build_run_arrays(src, dst, ts, marker, prop, n,
                                           vcap=cap)
                run = csr.repad_run(run, cap, cap)
                rf = self._wrap(run, level=0)
                new_index = mlindex.note_l0_flush(
                    self._state.index, run.vkeys, rf.nv, rf.fid)
                self.io.flush_write += rf.nbytes
                self.io.index_write += rf.nv * 8
                obs.counter("store_level_write_bytes", store=self.obs_label,
                            level="0").inc(rf.nbytes)
                new_runs = dict(self._state.runs_by_fid)
                new_runs[rf.fid] = rf
                deg = self.degraded_ranges()
                with self._lock:
                    st = self._state
                    new_levels = (st.levels[0] + (rf,),) + st.levels[1:]
                    version = self.versions.publish(
                        (st.mem_id,),
                        tuple(r.fid for r in new_levels[0]), st.tau)
                    self._swap_state(
                        levels=new_levels, index=new_index,
                        runs_by_fid=new_runs, mem_full=None,
                        mem_full_id=None, version=version,
                        degraded=deg, spine=_SpineHandle())
                    need_compact = (len(new_levels[0])
                                    >= self.cfg.l0_run_limit)
                self._obs_update_level_gauges(new_levels)
                obs.REGISTRY.trace_instant("store_flush_commit",
                                           store=self.obs_label,
                                           fid=str(rf.fid))
                if self.durability is not None:
                    self.durability.on_flush_commit(rf, wal_floor=wal_floor)
        if need_compact:
            self.compact_l0()
        return rf

    def _wrap(self, run: csr.CSRRunArrays, level: int) -> RunFile:
        """Materialize a RunFile (fid allocation under its own lock).
        Registration in ``runs_by_fid`` happens at commit time."""
        nv, ne = (int(x) for x in torch.stack([run.nv, run.ne]).tolist())
        if nv > 0:
            vk = run.vkeys[:nv].cpu().numpy()
            min_v, max_v = int(vk[0]), int(vk[-1])
            presence = filters.from_vkeys(vk)
        else:
            min_v, max_v = 0, -1
            presence = filters.from_vkeys(np.empty(0, np.int64))
        return RunFile(fid=self._new_fid(), level=level, arrays=run,
                       min_vid=min_v, max_vid=max_v, created_ts=self._ts,
                       nv=nv, ne=ne, io=self.io, presence=presence)

    # ------------------------------------------------------------ compaction
    def compact_l0(self) -> None:
        """Whole-L0 compaction (paper: all overlapping L0 CSRs merge in one
        compaction).  The merge runs outside the store lock over immutable
        pinned runs; only the metadata swap locks."""
        with self._compact_lock:
            st = self._state
            l0 = [r for r in st.levels[0] if r.nv > 0]
            l0_all = list(st.levels[0])
            if not l0:
                if l0_all:
                    self._drop_empty_l0(l0_all)
                return
            lo = min(r.min_vid for r in l0)
            hi = max(r.max_vid for r in l0) + 1
            overlap = [r for r in st.levels[1]
                       if r.nv > 0 and r.min_vid < hi and r.max_vid >= lo]
            self._merge_into(sources=l0, overlap=overlap, target_level=1,
                             range_lo=lo, range_hi=hi,
                             l0_max_fid=max(r.fid for r in l0),
                             also_remove=l0_all)
            self._maybe_cascade(1)

    def _drop_empty_l0(self, empties: List[RunFile]) -> None:
        """Publish L0 minus zero-vertex runs (defensive; no record moves)."""
        drop = {r.fid for r in empties}
        with self._flush_lock:
            new_runs = {f: r for f, r in self._state.runs_by_fid.items()
                        if f not in drop}
            with self._lock:
                st = self._state
                new_levels = (tuple(r for r in st.levels[0]
                                    if r.fid not in drop),) + st.levels[1:]
                version = self.versions.publish(
                    (st.mem_id,) + ((st.mem_full_id,)
                                    if st.mem_full_id is not None else ()),
                    tuple(r.fid for r in new_levels[0]), st.tau)
                self._swap_state(levels=new_levels, runs_by_fid=new_runs,
                                 version=version, spine=_SpineHandle())
            self._obs_update_level_gauges(new_levels)

    def compact_partial(self, level: int) -> None:
        """Partial compaction: move ONE segment file of `level` down (paper
        §4.2.1) — only overlapping target segments participate."""
        with self._compact_lock:
            st = self._state
            segs = st.levels[level]
            if not segs:
                return
            src_seg = max(segs, key=lambda r: r.ne)
            lo, hi = src_seg.min_vid, src_seg.max_vid + 1
            overlap = [r for r in st.levels[level + 1]
                       if r.nv > 0 and r.min_vid < hi and r.max_vid >= lo]
            self._merge_into(sources=[src_seg], overlap=overlap,
                             target_level=level + 1, range_lo=lo, range_hi=hi,
                             l0_max_fid=None, also_remove=[src_seg])
            self._maybe_cascade(level + 1)

    def _merge_into(self, **kw) -> None:
        with obs.REGISTRY.span("store_compaction", store=self.obs_label,
                               level=str(kw["target_level"])):
            self._merge_into_timed(**kw)

    def _merge_into_timed(self, *, sources: List[RunFile],
                          overlap: List[RunFile], target_level: int,
                          range_lo: int, range_hi: int,
                          l0_max_fid: Optional[int],
                          also_remove: List[RunFile]) -> None:
        # ---- compute phase: no lock, immutable inputs ----
        all_runs = [r.ensure_loaded() for r in sources + overlap]
        tot_e = sum(r.ne for r in sources + overlap)
        self.io.compaction_read += sum(r.nbytes for r in sources + overlap)
        tau_min = self.versions.min_live_tau(self._ts)
        vcap = csr.quantize_cap(max(tot_e, 1))
        is_bottom = target_level == self.cfg.n_levels - 1
        merged = csr.merge_runs(all_runs, tau_min, vcap=vcap,
                                is_bottom=is_bottom)
        new_segs = self._resegment(merged, target_level)
        written = sum(r.nbytes for r in new_segs)
        self.io.compaction_write += written
        obs.counter("store_level_write_bytes", store=self.obs_label,
                    level=str(target_level)).inc(written)
        if self.durability is not None:
            self.durability.on_compact_segments(new_segs)
        # ---- commit phase: publish, not mutate-under-lock ----
        with self._flush_lock:
            self._commit_merge(sources=sources, overlap=overlap,
                               new_segs=new_segs,
                               merged_nv=sum(s.nv for s in new_segs),
                               target_level=target_level,
                               range_lo=range_lo, range_hi=range_hi,
                               l0_max_fid=l0_max_fid,
                               also_remove=also_remove)
            if self.durability is not None:
                removed = {r.fid: r for r in also_remove + overlap}
                self.durability.on_compact_commit(
                    [removed[f] for f in sorted(removed)], new_segs,
                    target_level)

    def _commit_merge(self, *, sources, overlap, new_segs, merged_nv,
                      target_level, range_lo, range_hi, l0_max_fid,
                      also_remove) -> None:
        """Build the post-compaction membership + index functionally (caller
        holds ``_flush_lock``), then install it with one commit-lock swap."""
        st = self._state
        src_level = target_level - 1
        removed_fids = {r.fid for r in also_remove}
        new_levels = list(st.levels)
        new_levels[src_level] = tuple(
            r for r in st.levels[src_level] if r.fid not in removed_fids)
        overlap_fids = {r.fid for r in overlap}
        keep = [r for r in st.levels[target_level]
                if r.fid not in overlap_fids]
        new_levels[target_level] = tuple(sorted(
            keep + new_segs, key=lambda r: r.min_vid))
        new_levels = tuple(new_levels)
        # Index + vertex-grained version control (paper §4.3): the new (fid,
        # offset) per vertex, the cleared source level, and — for L0
        # compactions — min readable L0 fid = max involved fid + 1.  The
        # reference makes one call per output segment and per annihilated
        # gap; their ranges are disjoint, so one folded pass gives the same
        # target level and L0.  The source level is cleared over the
        # compacted source range only, not over the output segments'
        # (wider) ranges as the reference does — see mlindex.
        if new_segs:
            covered = [(s.min_vid, s.max_vid + 1) for s in new_segs]
            ranges = covered + _range_gaps(range_lo, range_hi, covered)
        else:
            ranges = [(range_lo, range_hi)]   # everything annihilated
        index = mlindex.note_compaction_many(
            st.index, level=target_level,
            writes=[(s.arrays.vkeys, s.arrays.voff, s.nv, s.fid)
                    for s in new_segs],
            ranges=ranges, src_ranges=[(range_lo, range_hi)],
            l0_min_fid_update=(l0_max_fid + 1 if l0_max_fid is not None
                               else -1))
        self.io.index_write += merged_nv * 8
        new_runs = dict(st.runs_by_fid)
        for r in sources + overlap:
            new_runs.pop(r.fid, None)
        for seg in new_segs:
            new_runs[seg.fid] = seg
        deg = self.degraded_ranges()
        with self._lock:
            cur = self._state  # re-read: mem/tau may have advanced
            version = self.versions.publish(
                (cur.mem_id,) + ((cur.mem_full_id,)
                                 if cur.mem_full_id is not None else ()),
                tuple(r.fid for r in new_levels[0]), cur.tau)
            self._swap_state(levels=new_levels, index=index,
                             runs_by_fid=new_runs, version=version,
                             degraded=deg, spine=_SpineHandle())
        self._obs_update_level_gauges(new_levels)
        obs.REGISTRY.trace_instant("store_compact_commit",
                                   store=self.obs_label,
                                   level=str(target_level),
                                   segs=str(len(new_segs)))

    def _resegment(self, merged: csr.CSRRunArrays,
                   level: int) -> List[RunFile]:
        """Split a merged run into segment files at vertex boundaries,
        balancing sizes; a very high degree vertex gets its own segment
        (paper §4.2.1).  Each segment is a contiguous slice."""
        ne, nv = (int(x) for x in torch.stack([merged.ne, merged.nv]).tolist())
        if ne == 0:
            return []
        target = self.cfg.seg_target_edges
        voff = merged.voff[:nv + 1].cpu().numpy()
        dev = self.device
        segs: List[RunFile] = []
        start_v = 0
        while start_v < nv:
            end_v = int(np.searchsorted(voff, voff[start_v] + target,
                                        side="right")) - 1
            end_v = min(max(end_v, start_v + 1), nv)
            e_lo, e_hi = int(voff[start_v]), int(voff[end_v])
            n_v, n_e = end_v - start_v, e_hi - e_lo
            vcap, ecap = csr.quantize_cap(n_v), csr.quantize_cap(max(n_e, 1))
            sub = csr.CSRRunArrays(
                vkeys=merged.vkeys[start_v:end_v],
                voff=merged.voff[start_v:end_v + 1] - e_lo,
                dst=merged.dst[e_lo:e_hi], ts=merged.ts[e_lo:e_hi],
                marker=merged.marker[e_lo:e_hi], prop=merged.prop[e_lo:e_hi],
                nv=scalar(n_v, dev), ne=scalar(n_e, dev))
            segs.append(self._wrap(csr.repad_run(sub, vcap, ecap),
                                   level=level))
            start_v = end_v
        return segs

    def _maybe_cascade(self, level: int) -> None:
        if level >= self.cfg.n_levels - 1:
            return
        size = sum(r.ne for r in self._state.levels[level])
        if size > self.cfg.level_capacity(level):
            self.compact_partial(level)

    # ------------------------------------------------------------------ read
    def snapshot(self) -> "Snapshot":
        """Pin a consistent view — one atomic read of the published state
        plus a version-chain pin; no store lock is taken."""
        st = self._state
        self.versions.pin(st.version, st.tau)
        return Snapshot(self, st)

    def query_edge(self, u: int, v: int) -> bool:
        with self.snapshot() as snap:
            return bool(snap.query_edges_batch([u], [v])[0])

    def query_edges_batch(self, us, vs) -> np.ndarray:
        """Batched point-membership: one snapshot, one batched resolve."""
        with self.snapshot() as snap:
            return snap.query_edges_batch(us, vs)

    # ------------------------------------------------------------ durability
    def sync(self) -> None:
        """Durability barrier: fsync the WAL tail (no-op when in-memory)."""
        if self.durability is not None:
            self.durability.sync()

    def ack(self, commit_seq: Optional[int]) -> None:
        """Await durability of ONE write batch: blocks until the WAL record
        with ``commit_seq`` (returned by ``insert_edges``/``delete_edges``)
        is fsynced.  No-op for in-memory stores or a ``None`` seq."""
        if commit_seq is not None and self.durability is not None:
            self.durability.sync_upto(commit_seq)

    def _install_recovered(self, levels, index, tau: int,
                           next_fid: int) -> None:
        """Publish the initial state reconstructed by ``storage.recovery``:
        one swap installs the recovered run membership, rebuilt index, and
        replayed tau (recovery builds its level lists locally, never
        poking published state)."""
        levels_t = tuple(tuple(lvl) for lvl in levels)
        runs = {r.fid: r for lvl in levels_t for r in lvl}
        deg = self.degraded_ranges()
        with self._flush_lock, self._write_lock:
            with self._fid_lock:
                self._next_fid = max(self._next_fid, next_fid)
            with self._lock:
                self._ts = max(self._ts, tau)
                st = self._state
                version = self.versions.publish(
                    (st.mem_id,) + ((st.mem_full_id,)
                                    if st.mem_full_id is not None else ()),
                    tuple(r.fid for r in levels_t[0]), self._ts)
                self._swap_state(levels=levels_t, index=index,
                                 runs_by_fid=runs, tau=self._ts,
                                 version=version, degraded=deg,
                                 spine=_SpineHandle())
        self._obs_update_level_gauges(levels_t)

    def degraded_ranges(self) -> tuple:
        """Vertex ranges whose on-disk data is quarantined/unreadable
        (``storage.errors.DegradedRange`` tuples).  Empty for in-memory
        stores and healthy durable stores.  Queries overlapping a degraded
        range raise a typed ``CorruptionError`` instead of returning
        silently-incomplete adjacency."""
        if self.durability is not None and \
                hasattr(self.durability, "degraded_ranges"):
            return self.durability.degraded_ranges()
        return ()

    def close(self) -> None:
        """Flush WAL buffers and release file handles.  The store stays
        usable for reads but further writes are undefined; reopen via
        ``repro_torch.storage.open_store``."""
        if self.durability is not None:
            self.durability.close()

    # ----------------------------------------------------------------- stats
    def level_sizes(self) -> List[int]:
        return [sum(r.ne for r in lvl) for lvl in self.levels]

    def disk_bytes(self) -> int:
        """Space cost (Fig 14).  Durable mode reports ACTUAL on-disk bytes
        (WAL + segments + manifest); in-memory mode keeps the byte-accounting
        proxy over live runs + index."""
        if self.durability is not None:
            return self.durability.disk_bytes()
        run_bytes = sum(r.nbytes for lvl in self.levels for r in lvl)
        return run_bytes + mlindex.index_nbytes_dense(
            self.cfg.vmax, self.cfg.n_levels)


def slice_adjacency(offs: np.ndarray, dst: np.ndarray, prop: np.ndarray,
                    inv: np.ndarray, return_props: bool) -> list:
    """Expand a resolved (offsets, dst, prop) block into the per-query
    result list: element j is the slice for unique vertex ``inv[j]``."""
    offs_l = np.asarray(offs).tolist()
    if return_props:
        return [(dst[offs_l[i]:offs_l[i + 1]], prop[offs_l[i]:offs_l[i + 1]])
                for i in inv.tolist()]
    return [dst[offs_l[i]:offs_l[i + 1]] for i in inv.tolist()]


def _pad(a: np.ndarray, n: int) -> np.ndarray:
    if len(a) == n:
        return a
    out = np.zeros(n, a.dtype)
    out[:len(a)] = a
    return out


def _range_gaps(lo: int, hi: int,
                covered: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    gaps, cur = [], lo
    for (clo, chi) in sorted(covered):
        if clo > cur:
            gaps.append((cur, clo))
        cur = max(cur, chi)
    if cur < hi:
        gaps.append((cur, hi))
    return gaps


class Snapshot:
    """A pinned consistent view — one published ``StoreState``.  The state
    was frozen at publication and commits create new tensors, never
    mutate pinned ones, so the pin is trivially consistent."""

    # Bound on unique vertices per device resolve.
    _BATCH_CHUNK = 1 << 14

    def __init__(self, store: LSMGraph, state: StoreState):
        self._store = store
        self.state = state
        self.version = state.version
        self.tau = state.tau
        self.cfg = store.cfg
        self.device = store.device
        self.index = state.index
        self.mem_states: List[MemGraphState] = [state.mem]
        if state.mem_full is not None:
            self.mem_states.append(state.mem_full)
        self.degraded = store.degraded_ranges()
        bad_fids = {r.fid for r in self.degraded}
        self.l0_runs: List[RunFile] = [
            r for r in state.levels[0] if r.fid not in bad_fids]
        self.level_runs: List[List[RunFile]] = [
            [r for r in lvl if r.fid not in bad_fids]
            for lvl in state.levels[1:]]
        # Evicted (durable, cold) segments stay cold at pin time: every read
        # path materializes lazily via ensure_loaded, and a run's file can't
        # vanish under a pin — compaction re-materializes the runs it removes
        # before unlinking their files (engine.on_compact_commit).
        self.runs_by_fid = {r.fid: r
                            for lvl in ([self.l0_runs] + self.level_runs)
                            for r in lvl}
        self._released = False

    def release(self) -> None:
        if not self._released:
            self._store.versions.unpin(self.version.vid, self.tau)
            self._released = True

    def __enter__(self) -> "Snapshot":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -------------------------------------------------------------- raw runs
    def all_run_records(self):
        """(src, dst, ts, marker, prop, fid) numpy record arrays of every
        visible run incl. MemGraph tiers (fid None)."""
        return [tuple(x.cpu().numpy() for x in rec[:5]) + (rec[5],)
                for rec in self.run_record_tensors()]

    def run_record_tensors(self):
        """``all_run_records`` as tensors on the store's device (the
        analytics views read them there)."""
        recs = []
        for mg in self.mem_states:
            src, dst, ts, marker, prop, n = mg_mod.flush_arrays(mg)
            n = int(n)
            recs.append(tuple(x[:n] for x in (src, dst, ts, marker, prop))
                        + (None,))
        for rf in self.l0_runs + [r for lvl in self.level_runs for r in lvl]:
            a = rf.ensure_loaded()
            ne = rf.ne
            recs.append(tuple(x[:ne] for x in (
                csr.expand_src(a), a.dst, a.ts, a.marker, a.prop))
                + (rf.fid,))
        return recs

    # ------------------------------------------------------------- neighbors
    def neighbors(self, v: int, return_props: bool = False):
        """Exact adjacency of v at τ (a one-element batched read)."""
        return self.neighbors_batch(
            np.asarray([v], np.int64), return_props=return_props)[0]

    def neighbors_batch(self, vs, return_props: bool = False):
        """Adjacency of every vertex in `vs` at τ: a list parallel to `vs`
        of int64 dst arrays (ascending), or (dst, prop) tuples, byte-
        identical to the scalar path."""
        vs = np.asarray(vs, np.int64).ravel()
        if vs.size == 0:
            return []
        uniq, inv = np.unique(vs, return_inverse=True)
        self._check_degraded(uniq)
        if len(uniq) == 1:
            # Point-read fast path: the scalar slice-gather path is cheaper
            # for one vertex and identical.
            one = self.neighbors_scalar(int(uniq[0]),
                                        return_props=return_props)
            return [one] * len(vs)
        offs, dst, prop = self._resolve_batch_chunked(uniq)
        return slice_adjacency(offs, dst, prop, inv, return_props)

    def degraded_overlap(self, u) -> tuple:
        if not self.degraded:
            return ()
        u = np.asarray(u)
        return tuple(r for r in self.degraded
                     if bool(((u >= r.lo) & (u <= r.hi)).any()))

    def _check_degraded(self, u) -> None:
        hit = self.degraded_overlap(u)
        if hit:
            # Runtime-only import: storage imports core at module load.
            from ..storage.errors import CorruptionError
            raise CorruptionError(
                "query touches degraded vertex range(s) "
                + ", ".join(f"[{r.lo}, {r.hi}] (fid {r.fid})" for r in hit),
                ranges=hit)

    def _prefetch_range(self, lo: int, hi: int,
                        queries: Optional[np.ndarray] = None) -> int:
        """Kick background loads for every cold visible run whose vertex
        range overlaps [lo, hi] — host metadata only, no device sync, so
        disk I/O overlaps whatever the caller dispatches next.  When the
        exact query vector is known, each run's presence filter gates the
        schedule: a cold run that rejects EVERY query is provably untouched
        by the resolve, so its disk load is skipped.  Returns the number of
        loads scheduled."""
        if hi < lo:
            return 0
        use_filters = queries is not None and _read_filters_enabled()
        n = 0
        pool = None
        for rf in self.runs_by_fid.values():
            if (rf.arrays is None and rf.nv > 0
                    and rf.max_vid >= lo and rf.min_vid <= hi):
                if (use_filters and rf.presence is not None
                        and not rf.presence.might_contain(queries).any()):
                    continue
                if pool is None:
                    pool = prefetch_pool()
                n += rf.prefetch(pool)
        return n

    def _resolve_batch_chunked(self, u: np.ndarray):
        if len(u) <= self._BATCH_CHUNK:
            return self._resolve_batch(u)
        # Uniform chunk padding: every chunk resolves at one query width.
        chunk_pad = csr.quantize_cap(self._BATCH_CHUNK, minimum=64)
        chunks = [u[lo:lo + self._BATCH_CHUNK]
                  for lo in range(0, len(u), self._BATCH_CHUNK)]
        offs_l, dst_l, prop_l = [np.zeros(1, np.int64)], [], []
        base = 0
        for i, cu in enumerate(chunks):
            if i + 1 < len(chunks) and not self.spine_ready():
                # Double-buffer (legacy / pre-spine): chunk i+1's cold
                # segments stream in while chunk i resolves.  Once the
                # spine exists, chunks never touch segment arrays again.
                nxt = chunks[i + 1]
                self._prefetch_range(
                    int(nxt[0]), int(nxt[-1]),
                    queries=nxt if _READ_TOURNAMENT_MAX_K <= 0 else None)
            offs, dst, prop = self._resolve_batch(cu, pad_to=chunk_pad)
            offs_l.append(offs[1:] + base)
            dst_l.append(dst)
            prop_l.append(prop)
            base += len(dst)
        return (np.concatenate(offs_l), np.concatenate(dst_l),
                np.concatenate(prop_l))

    def spine_ready(self) -> bool:
        return self.state.spine.ready()

    def _get_backbone(self) -> _ReadBackbone:
        return self.state.spine.get(self.state, self._store)

    def _resolve_batch(self, u: np.ndarray, pad_to: Optional[int] = None):
        """Timed wrapper over ``_resolve_batch_impl``: every device resolve
        lands in the store's ``read_resolve_seconds`` histogram."""
        t0 = time.perf_counter()
        out = self._resolve_batch_impl(u, pad_to)
        dt = time.perf_counter() - t0
        self._store._obs_resolve.observe(dt)
        self._store._obs_read_queries.inc(len(u))
        ring = obs.REGISTRY.trace_ring  # one check; None = tracing off
        if ring is not None:
            ring.append({"name": "read_resolve",
                         "labels": {"store": self._store.obs_label,
                                    "queries": str(len(u))},
                         "t0": t0, "dur": dt, "depth": 0,
                         "thread": threading.current_thread().name,
                         "ok": True})
        return out

    def _visibility(self, bb: _ReadBackbone, u_j: torch.Tensor):
        """bool[R, bp] per-(run, query) visibility from the multi-level
        index: an L0 run is visible to v iff its fid >= v's min readable fid
        and >= v's first L0 fid; an L1+ run iff the index names it at its
        level.  One vectorized pass over every run."""
        bp = u_j.shape[0]
        r = bb.run_fid.shape[0]
        if r == 0:
            return torch.zeros((1, bp), dtype=torch.bool, device=u_j.device)
        if not self.cfg.use_multilevel_index:
            # Ablation: no index — every run is probed (Fig 16 baseline).
            return torch.ones((r, bp), dtype=torch.bool, device=u_j.device)
        first, min_fid, lvl_fid, _ = mlindex.lookup_batch(self.index, u_j)
        f = bb.run_fid[:, None]
        vis_l0 = (f >= min_fid[None, :]) & (
            (first[None, :] == INVALID_VID) | (f >= first[None, :]))
        vis_lvl = lvl_fid.t()[bb.run_col.clamp(min=0)] == f
        return torch.where((bb.run_col < 0)[:, None], vis_l0, vis_lvl)

    def _resolve_batch_impl(self, u: np.ndarray,
                            pad_to: Optional[int] = None):
        """Resolve a SORTED UNIQUE query vector: (offsets[B+1], dst, prop),
        with dst ascending within each query's slice.

        Rides the state's shared sealed-tier read spine: one vectorized rank
        of the query vector into the spine + the per-query visibility gate
        (index, then presence filters) + one segmented annihilation.  The
        ACTIVE MemGraph is resolved separately and its visible (src, dst)
        pairs suppress the sealed winners (ts tier dominance)."""
        B = len(u)
        bp = pad_to if pad_to is not None else csr.quantize_cap(B, minimum=64)
        if bp < B:
            raise ValueError("pad_to below query count")
        dev = self.device
        if B and not self.spine_ready():
            # Pre-spine only: once the spine holds the merged records,
            # evicted runs are never read again on this snapshot.  Filter
            # gating applies only on the legacy path: the spine build
            # merges every run regardless.
            self._prefetch_range(
                int(u[0]), int(u[-1]),
                queries=u if _READ_TOURNAMENT_MAX_K <= 0 else None)
        u_pad = np.full(bp, INVALID_VID, np.int32)
        u_pad[:B] = u
        u_j = torch.from_numpy(u_pad).to(dev)
        if _READ_TOURNAMENT_MAX_K <= 0:
            return self._resolve_batch_legacy(u, u_j)
        bb = self._get_backbone()
        mem = self.state.mem
        have_mem = int(mem.ne) != 0
        store = self._store
        if bb.src.shape[0] == 0 and not have_mem:
            store._obs_read_probes.inc(0)
            return (np.zeros(B + 1, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.float32))
        parts = []
        n_run = 0
        probed = int(have_mem)
        if bb.src.shape[0]:
            vis = self._visibility(bb, u_j)
            if bb.fwords is not None and _read_filters_enabled():
                # One membership test of the whole query vector against
                # every run's filter, ANDed into the visibility matrix so
                # filtered-out pairs are dropped before rank + annihilation.
                # Zero false negatives, so results stay byte-identical.
                fhit = kops.presence_matrix(bb.fwords, bb.foffs, bb.fmasks,
                                            u_j)
                pre = int(vis[:, :B].sum())
                vis &= fhit
                store._obs_filter_checked.inc(pre)
                store._obs_filter_skipped.inc(pre - int(vis[:, :B].sum()))
            if bb.run_fid.shape[0]:
                probed += int(vis[:, :B].any(dim=1).sum())
            qid, live, n_run_t = _backbone_resolve(
                bb.src, bb.dst, bb.ts, bb.rid, bb.marker, u_j, vis,
                self.tau, B)
            n_run = int(n_run_t)
            idx = torch.nonzero(live).reshape(-1)
            parts.append((qid[idx], bb.dst[idx], bb.prop[idx]))
        store._obs_read_probes.inc(probed)
        if have_mem:
            mq, md, mp, pq, pd, n_present = _mem_resolve(
                *mg_mod.scan_vertices_batch(mem, u_j), self.tau, B)
            if parts:
                q, d, p = parts[0]
                keep = ~_suppressed(q, d, pq, pd, n_present)
                parts[0] = (q[keep], d[keep], p[keep])
            parts.append((mq, md, mp))
        parts = [tuple(x.cpu().numpy() for x in part) for part in parts]
        return self._finish_resolve(parts, n_run, B)

    def _resolve_batch_legacy(self, u: np.ndarray, u_j: torch.Tensor):
        """Per-resolve concat + one segmented lexsort (the pre-spine read
        path, kept behind LSMG_READ_TOURNAMENT_K=0): the records of every
        run with a visible query, and of the MemGraph tiers, annihilated
        per (query, dst) in one sort."""
        B = len(u)
        bp = u_j.shape[0]
        lo_q, hi_q = (int(u[0]), int(u[-1])) if B else (0, -1)
        mems = [mg for mg in self.mem_states if int(mg.ne) != 0]
        first, min_fid, lvl_fid, _ = mlindex.lookup_batch(self.index, u_j)
        first_np, min_np = first.cpu().numpy(), min_fid.cpu().numpy()
        lvl_np = lvl_fid.cpu().numpy()
        use_filters = _read_filters_enabled()
        store = self._store

        def filter_vis(rf, vis):
            # The run's presence filter (host hash) ANDed into its
            # visibility row before the any() gate, so a run every query
            # misses is skipped.  Rows the index names skip this: the
            # multi-level index is exact per vertex.
            if not use_filters or rf.presence is None:
                return vis
            pre = int(np.count_nonzero(vis[:B]))
            vis = vis.copy()
            vis[:B] &= rf.presence.might_contain(u)
            store._obs_filter_checked.inc(pre)
            store._obs_filter_skipped.inc(
                pre - int(np.count_nonzero(vis[:B])))
            return vis

        runs: List[Tuple[RunFile, Optional[np.ndarray]]] = []
        for rf in self.l0_runs:
            if rf.nv == 0 or rf.max_vid < lo_q or rf.min_vid > hi_q:
                continue
            vis = ((rf.fid >= min_np)
                   & ((first_np == INVALID_VID) | (rf.fid >= first_np)))
            vis = filter_vis(rf, vis)
            if vis[:B].any():
                runs.append((rf, vis))
        if self.cfg.use_multilevel_index:
            for col, lvl in enumerate(self.level_runs):
                for rf in lvl:
                    if rf.nv == 0:
                        continue
                    vis = lvl_np[:, col] == rf.fid
                    if vis[:B].any():
                        runs.append((rf, vis))
        else:
            # Ablation: no index (Fig 16 baseline) — every run whose vertex
            # range meets the queries' is probed, past its filter.
            for lvl in self.level_runs:
                for rf in lvl:
                    if rf.nv == 0 or rf.max_vid < lo_q or rf.min_vid > hi_q:
                        continue
                    vis = filter_vis(rf, np.ones(bp, bool))
                    if not vis[:B].any():
                        continue
                    runs.append((rf, vis if use_filters
                                 and rf.presence is not None else None))
        store._obs_read_probes.inc(len(runs) + len(mems))
        if not mems and not runs:
            return (np.zeros(B + 1, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.float32))
        q, d, p, live, n_run = _merge_lexsort(mems, runs, u_j, self.tau, B)
        idx = torch.nonzero(live).reshape(-1)
        part = tuple(x[idx].cpu().numpy() for x in (q, d, p))
        return self._finish_resolve([part], n_run, B)

    def _finish_resolve(self, parts, n_run: int, B: int):
        """Combine the live records of each part into the final (offsets,
        dst, prop).  The (qid, dst) pairs are disjoint across parts and
        unique within each, so the sort is a deterministic merge —
        byte-identical to annihilating one merged stream.  One part (the
        legacy path's) is already sorted by (qid, dst)."""
        self._store.io.analytics_read += n_run * _REC_BYTES
        ql = np.concatenate([p[0] for p in parts]).astype(np.int64)
        dl = np.concatenate([p[1] for p in parts]).astype(np.int64)
        pl = np.concatenate([p[2] for p in parts]).astype(np.float32)
        if len(parts) > 1:
            order = np.lexsort((dl, ql))
            ql, dl, pl = ql[order], dl[order], pl[order]
        self._store._obs_read_returned.inc(len(dl) * _REC_BYTES)
        offs = np.searchsorted(ql, np.arange(B + 1))
        return offs, dl, pl

    def neighbors_scalar(self, v: int, return_props: bool = False):
        """Reference per-vertex read path: MemGraph first, then L0 runs with
        fid >= max(first, min readable fid), then one (fid, offset) per L1+
        level from the multi-level index (paper read workflow).  Kept as the
        equivalence oracle for `neighbors_batch`."""
        self._check_degraded(np.asarray([v]))
        recs: List[Tuple[np.ndarray, ...]] = []
        cap = self.cfg.seg_size + self.cfg.ovf_cap  # max cacheable degree
        for mg in self.mem_states:
            if int(mg.ne) == 0:
                continue
            d, t, m, p, mask = mg_mod.scan_vertex(mg, v, cap=cap)
            recs.append(tuple(x[mask].cpu().numpy() for x in (d, t, m, p)))
        first_fid, min_fid = (int(x) for x in torch.stack(
            [self.index.l0_first_fid[v], self.index.l0_min_fid[v]]).tolist())
        lvl_fid = self.index.lvl_fid[v].cpu().numpy()
        lvl_off = self.index.lvl_off[v].cpu().numpy()
        bytes_read = 0
        use_filters = _read_filters_enabled()
        store = self._store

        def filter_rejects(rf) -> bool:
            if not use_filters or rf.presence is None:
                return False
            store._obs_filter_checked.inc(1)
            if not bool(rf.presence.might_contain(v)[0]):
                store._obs_filter_skipped.inc(1)
                return True
            return False

        def note_fp(rf) -> None:
            if use_filters and rf.presence is not None:
                store._obs_filter_fp.inc(1)

        for rf in self.l0_runs:
            if rf.fid < min_fid or (first_fid != INVALID_VID
                                    and rf.fid < first_fid):
                continue
            if filter_rejects(rf):
                continue
            r = _gather_vertex(rf, v)
            if r is not None:
                recs.append(r)
                bytes_read += len(r[0]) * _REC_BYTES
            else:
                note_fp(rf)
        if self.cfg.use_multilevel_index:
            for col in range(lvl_fid.shape[0]):
                fid = int(lvl_fid[col])
                if fid == INVALID_VID or fid not in self.runs_by_fid:
                    continue
                r = _gather_vertex(self.runs_by_fid[fid], v,
                                   known_off=int(lvl_off[col]))
                if r is not None:
                    recs.append(r)
                    bytes_read += len(r[0]) * _REC_BYTES
        else:
            for lvl in self.level_runs:
                for rf in lvl:
                    if rf.nv == 0 or not (rf.min_vid <= v <= rf.max_vid):
                        continue
                    if filter_rejects(rf):
                        continue
                    r = _gather_vertex(rf, v)
                    if r is not None:
                        recs.append(r)
                        bytes_read += len(r[0]) * _REC_BYTES
                    else:
                        note_fp(rf)
        store.io.analytics_read += bytes_read
        store._obs_read_queries.inc(1)
        store._obs_read_probes.inc(len(recs))
        out = _annihilate(recs, self.tau, return_props)
        store._obs_read_returned.inc(
            len(out[0] if return_props else out) * _REC_BYTES)
        return out

    def query_edges_batch(self, us, vs) -> np.ndarray:
        """Batched edge-membership: bool[i] = (us[i] -> vs[i]) is live at τ,
        by bisection in the batched read's sorted adjacency slices."""
        us = np.asarray(us, np.int64).ravel()
        vs = np.asarray(vs, np.int64).ravel()
        if us.shape != vs.shape:
            raise ValueError("us and vs must have the same length")
        if us.size == 0:
            return np.zeros(0, bool)
        nbrs = self.neighbors_batch(us)
        out = np.zeros(len(us), bool)
        for i, (adj, v) in enumerate(zip(nbrs, vs)):
            j = int(np.searchsorted(adj, v))
            out[i] = j < len(adj) and int(adj[j]) == v
        return out

    def degree(self, v: int) -> int:
        return len(self.neighbors(v))

    def degrees_batch(self, vs) -> np.ndarray:
        return np.array([len(n) for n in self.neighbors_batch(vs)], np.int64)

    def edge_set(self) -> set:
        """Full live edge set at τ (verification only — O(E))."""
        vs = self.vertices()
        out = set()
        for v, nbrs in zip(vs.tolist(), self.neighbors_batch(vs)):
            out.update((v, int(d)) for d in nbrs)
        return out

    def vertices(self) -> np.ndarray:
        """Every vertex id seen at τ — as a source OR a destination."""
        vs = set()
        for (src, dst, ts, _marker, _prop, _fid) in self.all_run_records():
            m = ts <= self.tau
            vs.update(np.unique(src[m]).tolist())
            vs.update(np.unique(dst[m]).tolist())
        return np.array(sorted(vs), np.int64)


def _newest_per_pair(qid, dst, ts, marker, prop, tau: int, nq: int):
    """Sort records by (query, dst, ts), a record of no query or newer than
    τ keyed dead (INT32_MAX) so that it sorts to the tail, and mark the
    newest record of each (query, dst) pair: (q, d, marker, prop, last)."""
    qkey = torch.where((qid < nq) & (ts <= tau), qid, INVALID_VID).to(_I32)
    order = csr.lexsort_edges(qkey, dst, ts)
    q, d = qkey[order], dst[order]
    last = (q != torch.roll(q, -1)) | (d != torch.roll(d, -1))
    last[-1:] = True
    return q, d, marker[order], prop[order], last


def _mem_resolve(qid, dst, ts, marker, prop, tau: int, nq: int):
    """Annihilate the ACTIVE MemGraph tier's records per (query, dst): the
    newest τ-visible record of each pair wins (a tombstone winner hides the
    pair).  Returns the live records (qid, dst, prop) and the sorted
    (qid, dst) pair set holding ANY visible record, padded with INT32_MAX
    past ``n_present`` — the suppression probe for the sealed winners."""
    dead = INVALID_VID
    q, d, m, p, last = _newest_per_pair(qid, dst, ts, marker, prop, tau, nq)
    present = last & (q < nq)
    live = present & ~m
    pidx = torch.nonzero(present).reshape(-1)
    n_present = pidx.shape[0]
    pad = q.shape[0] - n_present
    fill = torch.full((pad,), dead, dtype=_I32, device=q.device)
    pq = torch.cat([q[pidx], fill])
    pd = torch.cat([d[pidx], fill])
    lidx = torch.nonzero(live).reshape(-1)
    return q[lidx], d[lidx], p[lidx], pq, pd, n_present


def _run_query_records(run: csr.CSRRunArrays, u: torch.Tensor,
                       vis_q: torch.Tensor):
    """Flat (qid, dst, ts, marker, prop) of one run restricted to queried
    vertices with per-query visibility vis_q (index / min-fid rules); qid
    is len(u) for every other record."""
    b = u.shape[0]
    qid = csr.map_run_to_queries(run, u)
    ok = (qid < b) & vis_q[qid.clamp(max=b - 1).long()]
    return (torch.where(ok, qid, b).to(_I32), run.dst, run.ts, run.marker,
            run.prop)


def _merge_lexsort(mems, runs, u: torch.Tensor, tau: int, nq: int):
    """Legacy merge: concat every source's records and run one segmented
    lexsort (``_annihilate_batch``).  ``runs`` pairs each run with its
    host visibility row over ``u`` (None: every query)."""
    recs = [mg_mod.scan_vertices_batch(mg, u) for mg in mems]
    n_mem = sum(int(r[0].shape[0]) for r in recs)
    every = torch.ones(u.shape, dtype=torch.bool, device=u.device)
    for rf, vis in runs:
        vis_t = every if vis is None else torch.from_numpy(vis).to(u.device)
        recs.append(_run_query_records(rf.ensure_loaded(), u, vis_t))
    cols = [torch.cat([r[i] for r in recs]) for i in range(5)]
    # Half-step buckets: the concat feeds the lexsort, this path's
    # dominant (pad-length-linear) cost.
    total = cols[0].shape[0]
    pad = csr.quantize_cap(total, half_steps=True) - total
    if pad:
        cols = [torch.cat([c, torch.full((pad,), fill, dtype=c.dtype,
                                         device=c.device)])
                for c, fill in zip(cols, (INVALID_VID, 0, 0, False, 0.0))]
    return _annihilate_batch(*cols, tau, nq, n_mem)


def _annihilate_batch(qid, dst, ts, marker, prop, tau: int, nq: int,
                      run_from: int):
    """Segmented annihilation: one lexsort by (qid, dst, ts) over every
    record of the batch; per (qid, dst) the newest ts <= τ wins and a
    tombstone winner hides the edge.  Also returns the count of queried
    run records (positions >= run_from), for the byte accounting."""
    pos = torch.arange(qid.shape[0], device=qid.device)
    n_run = int(((pos >= run_from) & (qid < nq)).sum())
    q, d, m, p, last = _newest_per_pair(qid, dst, ts, marker, prop, tau, nq)
    live = last & ~m & (q < nq)
    return q, d, p, live, n_run


def _suppressed(q, d, pq, pd, n_present: int) -> torch.Tensor:
    """Which sealed winners (q, d) the active tier also holds: one
    lexicographic binary search into the mem-present pair set."""
    if q.shape[0] == 0 or n_present == 0:
        return torch.zeros(q.shape, dtype=torch.bool, device=q.device)
    z = torch.zeros_like(q)
    pos = kops.lex_searchsorted((pq, pd, torch.zeros_like(pq)), q, d, z,
                                n_present, side="left")
    pos_c = pos.clamp(max=pq.shape[0] - 1).long()
    return (pos < n_present) & (pq[pos_c] == q) & (pd[pos_c] == d)


def _backbone_resolve(src, dst, ts, rid, marker, u, vis_mat, tau: int,
                      nq: int):
    """Resolve one query batch against the merged spine: rank every record
    into the query vector, gather its per-(run, query) visibility, then
    segmented annihilation — per (src, dst) group the newest ALIVE record
    wins (segmented max of alive positions) and a tombstone winner hides
    the edge.  Returns (qid, live, n_run), n_run being the queried run
    records (pre-τ visibility, for byte accounting)."""
    B = u.shape[0]
    n = src.shape[0]
    j = torch.searchsorted(u, src).clamp(max=B - 1)
    hit = (u[j] == src) & (src != INVALID_VID)
    rid_c = rid.clamp(0, vis_mat.shape[0] - 1).long()
    queried = hit & ((rid < 0) | vis_mat[rid_c, j])
    alive = queried & (ts <= tau)
    qid = torch.where(hit, j, B).to(_I32)
    idx = torch.arange(n, dtype=torch.int64, device=src.device)
    new_grp = (src != torch.roll(src, 1)) | (dst != torch.roll(dst, 1))
    new_grp[:1] = True
    gid = torch.cumsum(new_grp.to(torch.int64), 0) - 1
    winner = torch.full((n,), -1, dtype=torch.int64, device=src.device)
    winner.scatter_reduce_(0, gid, torch.where(alive, idx, -1), "amax")
    live = alive & (idx == winner[gid]) & ~marker & (qid < nq)
    n_run = (queried & (rid >= 0)).sum()
    return qid, live, n_run


def _gather_vertex(rf: RunFile, v: int, known_off: Optional[int] = None):
    if rf.nv == 0:
        return None
    a = rf.ensure_loaded()
    if known_off is None:
        found, start, end = csr.run_lookup(a, v)
        found, start, end = torch.stack(
            [found.to(_I32), start, end]).tolist()
        if not found:
            return None
    else:
        # Multi-level index gave the offset: O(1), no binary search.
        start = known_off
        nv = rf.nv
        vk = a.vkeys[:nv].cpu().numpy()
        voff = a.voff[:nv + 1].cpu().numpy()
        i = int(np.searchsorted(voff, start, side="right")) - 1
        end = int(voff[min(i + 1, nv)])
        if i >= nv or int(vk[i]) != v:
            return None
    if end <= start:
        return None
    return tuple(x[start:end].cpu().numpy()
                 for x in (a.dst, a.ts, a.marker, a.prop))


def _annihilate(recs, tau: int, return_props: bool):
    """Merge per-run records: newest ts <= τ wins per dst; tombstone hides."""
    empty = ((np.empty(0, np.int64), np.empty(0, np.float32))
             if return_props else np.empty(0, np.int64))
    if not recs:
        return empty
    dst = np.concatenate([r[0] for r in recs]).astype(np.int64)
    ts = np.concatenate([r[1] for r in recs]).astype(np.int64)
    marker = np.concatenate([r[2] for r in recs]).astype(bool)
    prop = np.concatenate([r[3] for r in recs]).astype(np.float32)
    m = ts <= tau
    dst, ts, marker, prop = dst[m], ts[m], marker[m], prop[m]
    if len(dst) == 0:
        return empty
    order = np.lexsort((ts, dst))
    dst, ts, marker, prop = dst[order], ts[order], marker[order], prop[order]
    last = np.ones(len(dst), bool)
    last[:-1] = dst[:-1] != dst[1:]
    live = last & ~marker
    if return_props:
        return dst[live], prop[live]
    return dst[live]
