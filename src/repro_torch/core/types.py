"""Core tensor types and configuration of the PyTorch port.

The port of ``repro.core.types``: every device structure is a NamedTuple of
fixed-capacity tensors plus 0-d int32 fill counts, laid out exactly as the
JAX package lays out its arrays (same fields, same dtypes, same padding),
so a state built by either package converts to the other field by field
(``repro_torch.convert``).  Host-side metadata (file ids, levels, byte
accounting) lives in plain dataclasses.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .. import obs

# Sentinel for "no vertex" — vertex ids must be < INVALID_VID.
INVALID_VID = (1 << 31) - 1

# Byte accounting mirroring the paper's on-disk edge body (dst, ts, prop_off,
# marker) with 8-byte vids in the paper; we count 16 B of topology + 4 B of
# property per edge, and 8 B per index entry.  Used only by the I/O proxy —
# the in-memory tensors are int32/float32.
BYTES_PER_EDGE = 16
BYTES_PER_PROP = 4
BYTES_PER_INDEX_ENTRY = 8


def resolve_device(device=None) -> torch.device:
    """The device a store's tensors live on: ``None`` means the current
    CUDA card, and raises when there is none (the port never falls back to
    the CPU on its own; the tests ask for ``"cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class EdgeBatch(NamedTuple):
    """A fixed-capacity batch of edge updates (insert or tombstone)."""

    src: torch.Tensor      # int32[BC]
    dst: torch.Tensor      # int32[BC]
    ts: torch.Tensor       # int32[BC] — globally unique, monotone per edge
    prop: torch.Tensor     # float32[BC]
    marker: torch.Tensor   # bool[BC] — True = deletion tombstone
    n: torch.Tensor        # int32[] — number of valid leading entries


class CSRRunArrays(NamedTuple):
    """One immutable CSR run ("CSR file" in the paper, Fig. 6).

    vkeys is the sorted list of distinct source vertices present (padded with
    INVALID_VID); voff[i]:voff[i+1] bounds vertex vkeys[i]'s edges, which are
    sorted by (dst, ts).  Properties are a parallel array = the paper's
    separate property file.
    """

    vkeys: torch.Tensor    # int32[Vc]
    voff: torch.Tensor     # int32[Vc+1]
    dst: torch.Tensor      # int32[Ec]
    ts: torch.Tensor       # int32[Ec]
    marker: torch.Tensor   # bool[Ec]
    prop: torch.Tensor     # float32[Ec]
    nv: torch.Tensor       # int32[] — valid vertices
    ne: torch.Tensor       # int32[] — valid edges

    @property
    def vcap(self) -> int:
        return self.vkeys.shape[0]

    @property
    def ecap(self) -> int:
        return self.dst.shape[0]


@dataclasses.dataclass(eq=False)  # identity eq: tensors are not comparable
class RunFile:
    """Host wrapper: a CSR run plus the paper's file-header metadata.

    ``arrays`` may be None if evicted to disk; ``loader`` (set by the
    durable storage engine, ``repro_torch.storage``) re-materializes them
    from the run's segment file onto the store's device.  An in-memory
    store keeps ``arrays`` resident and ``loader`` None."""

    fid: int
    level: int
    arrays: Optional[CSRRunArrays]
    min_vid: int
    max_vid: int
    created_ts: int
    nv: int
    ne: int
    path: Optional[str] = None
    loader: Optional[Callable[[], CSRRunArrays]] = dataclasses.field(
        default=None, repr=False)
    # Vertex-presence filter (core.filters.PresenceFilter) over this run's
    # source-vertex set.  None = no filter: always "maybe".  It stays
    # resident when the arrays are evicted: a cold run can still reject a
    # query without touching disk.
    presence: Optional[object] = dataclasses.field(default=None, repr=False)
    # Store-level I/O counters (set by the owning store).
    io: Optional["IOCounters"] = dataclasses.field(default=None, repr=False)
    # Orders load vs evict vs the compaction-commit re-materialize+unlink:
    # without it a reader past its None-check could open an already-deleted
    # segment file.
    _load_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)
    # Best-effort dedup of in-flight background loads; races are benign
    # (ensure_loaded serializes the actual load on _load_lock).
    _prefetching: bool = dataclasses.field(default=False, repr=False)

    @property
    def nbytes(self) -> int:
        return self.ne * (BYTES_PER_EDGE + BYTES_PER_PROP)

    # Cold-load instrumentation (slow path only).  A "hit" is a load that
    # found the arrays already materialized by prefetch or a concurrent
    # reader once under the lock; a "miss" pays the actual segment load.
    _OBS_HIT = obs.counter("read_prefetch_hit_total")
    _OBS_MISS = obs.counter("read_prefetch_miss_total")
    _OBS_SCHED = obs.counter("read_prefetch_scheduled_total")
    _OBS_LOAD = obs.histogram("storage_segment_load_seconds")
    # Bytes materialized by cold segment loads, process-wide.
    _OBS_COLD_BYTES = obs.counter("read_cold_load_bytes")

    def ensure_loaded(self, _retry_counter: str = "read_retries"
                      ) -> CSRRunArrays:
        """Materialize ``arrays`` (no-op when resident).  Returns a local
        reference, so a concurrent ``evict`` cannot null it between the
        check and the caller's use.

        The loader uploads with a synchronous copy on the calling thread's
        current stream (every thread of the port keeps the device's
        default stream), so the arrays are on the device before they are
        published here and any later reader's kernels are ordered after
        the copy.

        Transient loader failures (duck-typed: the exception carries
        ``transient = True``, e.g. an EIO on a cold segment read) are
        retried with bounded exponential backoff + wall-clock deadline
        (``LSMG_IO_RETRIES``, ``LSMG_IO_RETRY_BASE``,
        ``LSMG_IO_RETRY_DEADLINE``); each retry bumps
        ``io.<_retry_counter>``.  Corruption and other non-transient
        errors propagate on the first attempt.  The retry lives HERE —
        once, under the load lock — so foreground loads and background
        prefetch cannot stack retries multiplicatively."""
        a = self.arrays
        if a is not None:
            return a
        with self._load_lock:
            a = self.arrays
            if a is None:
                if self.loader is None:
                    raise RuntimeError(
                        f"RunFile fid={self.fid} has no arrays and no loader")
                self._OBS_MISS.inc()
                self._OBS_COLD_BYTES.inc(self.nbytes)
                if self.io is not None:
                    self.io.cold_load += self.nbytes
                t0 = time.perf_counter()
                a = self._load_with_retry(_retry_counter)
                self._OBS_LOAD.observe(time.perf_counter() - t0)
                self.arrays = a
            else:
                self._OBS_HIT.inc()
        return a

    def _load_with_retry(self, counter_attr: str) -> CSRRunArrays:
        attempts = int(os.environ.get("LSMG_IO_RETRIES", "3"))
        base = float(os.environ.get("LSMG_IO_RETRY_BASE", "0.002"))
        budget = float(os.environ.get("LSMG_IO_RETRY_DEADLINE", "2.0"))
        deadline = time.monotonic() + budget
        delay = base
        attempt = 0
        while True:
            try:
                return self.loader()
            except Exception as e:
                attempt += 1
                if (not getattr(e, "transient", False)
                        or attempt >= attempts
                        or time.monotonic() + delay > deadline):
                    raise
                if self.io is not None:
                    setattr(self.io, counter_attr,
                            getattr(self.io, counter_attr) + 1)
                time.sleep(delay)
                delay = min(delay * 2, 0.1)

    def prefetch(self, executor) -> bool:
        """Async counterpart of ``ensure_loaded``: start materializing
        ``arrays`` on ``executor`` if the run is cold.  The background load
        serializes with foreground loads/evicts on ``_load_lock``, so a
        concurrent ``ensure_loaded`` simply joins it.  Transient errors get
        the same bounded retry as foreground loads (counted separately in
        ``io.prefetch_retries``); a load that still fails leaves the run
        cold, and the foreground ``ensure_loaded`` that needs the run then
        loads it again and raises the error itself.
        Returns True iff a load was scheduled."""
        if self.arrays is not None or self.loader is None or self._prefetching:
            return False
        self._prefetching = True

        def _load() -> None:
            try:
                self.ensure_loaded(_retry_counter="prefetch_retries")
            except Exception:
                pass  # the run stays cold: the foreground load raises it
            finally:
                self._prefetching = False

        try:
            executor.submit(_load)
        except RuntimeError:      # pool shut down: foreground load covers it
            self._prefetching = False
            return False
        self._OBS_SCHED.inc()
        return True

    def evict(self) -> bool:
        """Drop the resident arrays (freeing their device memory) if a disk
        copy exists.  Returns True if evicted.  A concurrently pinned
        snapshot transparently reloads through ``ensure_loaded``."""
        with self._load_lock:
            if self.arrays is not None and self.loader is not None:
                self.arrays = None
                return True
            return False


class MemGraphState(NamedTuple):
    """MemGraph (paper §4.1): hashmap → fixed segments + overflow tier.

    Low-degree vertices live in one G-slot segment each; edges past G go to
    the overflow append-log (the stand-in for the paper's skip list:
    deferred ordering via sort-on-flush).
    """

    htab_key: torch.Tensor   # int32[H]  — INVALID_VID = empty
    htab_row: torch.Tensor   # int32[H]
    seg_owner: torch.Tensor  # int32[NS]
    seg_len: torch.Tensor    # int32[NS] — true cached degree (may exceed G)
    seg_dst: torch.Tensor    # int32[NS, G]
    seg_ts: torch.Tensor     # int32[NS, G]
    seg_marker: torch.Tensor  # bool[NS, G]
    seg_prop: torch.Tensor   # float32[NS, G]
    ovf_src: torch.Tensor    # int32[Oc]
    ovf_dst: torch.Tensor    # int32[Oc]
    ovf_ts: torch.Tensor     # int32[Oc]
    ovf_marker: torch.Tensor  # bool[Oc]
    ovf_prop: torch.Tensor   # float32[Oc]
    n_rows: torch.Tensor     # int32[]
    ovf_n: torch.Tensor      # int32[]
    ne: torch.Tensor         # int32[]

    @property
    def hcap(self) -> int:
        return self.htab_key.shape[0]

    @property
    def nseg(self) -> int:
        return self.seg_owner.shape[0]

    @property
    def segsize(self) -> int:
        return self.seg_dst.shape[1]

    @property
    def ovf_cap(self) -> int:
        return self.ovf_src.shape[0]


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """LSMGraph configuration (paper defaults: 64 MB MemGraph, T=10, 5 levels,
    two alternating MemGraphs)."""

    vmax: int = 1 << 16            # vertex-id space
    # -- MemGraph --
    mem_edges: int = 1 << 14       # P: flush threshold (edges)
    seg_size: int = 8              # G: slots per low-degree segment
    n_segments: int = 1 << 13      # NS: segment pool rows
    hash_slots: int = 1 << 14      # H (power of two)
    ovf_cap: int = 1 << 14         # Oc: overflow ("skip list") capacity
    batch_cap: int = 1 << 12       # BC: max edges per vectorized insert
    # -- levels --
    n_levels: int = 5
    level_factor: int = 10         # T
    l0_run_limit: int = 4          # flushes before L0→L1 compaction
    seg_target_edges: int = 1 << 15  # segment-file split target at L1+
    # -- behaviour --
    dedup_gc: bool = True          # drop superseded versions at compaction
    use_multilevel_index: bool = True   # Fig. 16 ablation switch
    memcache_mode: str = "memgraph"     # memgraph | array_only | skiplist_only

    def level_capacity(self, level: int) -> int:
        """Edge capacity of level i: P * T**i (L0 counts runs, not edges)."""
        return self.mem_edges * (self.level_factor ** max(level, 1))

    def validate(self) -> None:
        if self.hash_slots & (self.hash_slots - 1):
            raise ValueError("hash_slots must be a power of two")
        if self.n_segments * self.seg_size + self.ovf_cap < self.mem_edges:
            raise ValueError("segment pool + overflow below mem_edges")
        if self.batch_cap > self.mem_edges:
            raise ValueError("batch_cap above mem_edges")
        if self.memcache_mode not in ("memgraph", "array_only",
                                      "skiplist_only"):
            raise ValueError(f"unknown memcache_mode {self.memcache_mode!r}")


@dataclasses.dataclass
class IOCounters:
    """Bytes-moved accounting — the I/O proxy for the paper's disk-I/O plots.

    ``flush_write``/``compaction_*``/``analytics_read``/``index_write`` are
    the paper's logical-bytes proxy; the remaining fields count actual file
    bytes and advance only when a durable storage engine is attached.

    After ``bind(registry, **labels)`` every field write is mirrored into
    registry counters (``io_<field>_bytes``, or ``_total`` for retry
    counts).
    """

    flush_write: int = 0
    compaction_read: int = 0
    compaction_write: int = 0
    analytics_read: int = 0
    index_write: int = 0
    wal_write: int = 0
    segment_write: int = 0
    segment_read: int = 0
    manifest_write: int = 0
    cold_load: int = 0
    read_retries: int = 0
    prefetch_retries: int = 0

    def __setattr__(self, name: str, value) -> None:
        mirror = self.__dict__.get("_mirror")
        if mirror is not None:
            c = mirror.get(name)
            if c is not None:
                d = value - self.__dict__.get(name, 0)
                if d > 0:
                    c.inc(d)
        object.__setattr__(self, name, value)

    def bind(self, registry=None, **labels) -> "IOCounters":
        """Mirror this instance's fields into per-field registry counters,
        bootstrapping any value accumulated before binding."""
        registry = registry if registry is not None else obs.REGISTRY
        mirror = {}
        for f in dataclasses.fields(self):
            unit = "total" if f.name.endswith("retries") else "bytes"
            c = registry.counter(f"io_{f.name}_{unit}", **labels)
            cur = getattr(self, f.name)
            if cur > 0:
                c.inc(cur)
            mirror[f.name] = c
        self.__dict__["_mirror"] = mirror
        return self

    def total_write(self) -> int:
        return self.flush_write + self.compaction_write + self.index_write

    def durable_write(self) -> int:
        """Actual bytes written to disk (WAL + segment files)."""
        return self.wal_write + self.segment_write

    def as_dict(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}


@dataclasses.dataclass(frozen=True)
class Version:
    """A readable view (paper §4.3): MemGraph ids + L0 file ids + snapshot τ.

    L1+ visibility is carried by the multi-level index (vertex-grained), not
    by the version chain — exactly the paper's split.
    """

    vid: int
    memgraph_ids: Tuple[int, ...]
    l0_fids: Tuple[int, ...]
    tau: int


def scalar(x: int, device) -> torch.Tensor:
    """A 0-d int32 tensor (the fill counts of the NamedTuples above)."""
    return torch.tensor(int(x), dtype=torch.int32, device=device)
