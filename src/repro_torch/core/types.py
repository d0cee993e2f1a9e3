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
import threading
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

    The in-memory store keeps ``arrays`` resident; ``loader`` (a callable
    that rematerializes evicted arrays from a segment file) stays None until
    the port gains its durable storage engine."""

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
    # source-vertex set.  None = no filter: always "maybe".
    presence: Optional[object] = dataclasses.field(default=None, repr=False)
    # Store-level I/O counters (set by the owning store).
    io: Optional["IOCounters"] = dataclasses.field(default=None, repr=False)
    _load_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @property
    def nbytes(self) -> int:
        return self.ne * (BYTES_PER_EDGE + BYTES_PER_PROP)

    def ensure_loaded(self) -> CSRRunArrays:
        """The run's arrays, loading them through ``loader`` when evicted.
        Returns a local reference, so a concurrent evict cannot null it
        between the check and the caller's use."""
        a = self.arrays
        if a is not None:
            return a
        with self._load_lock:
            a = self.arrays
            if a is None:
                if self.loader is None:
                    raise RuntimeError(
                        f"RunFile fid={self.fid} has no arrays and no loader")
                a = self.loader()
                if self.io is not None:
                    self.io.cold_load += self.nbytes
                self.arrays = a
        return a


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
