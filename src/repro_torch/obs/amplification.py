"""Derived-metrics ledger: write / read / space amplification.

The port of ``repro.obs.amplification``: the same ratios, report schema and
gauge names, computed from the port's own ``REGISTRY``.

The paper's whole argument is phrased in amplification ratios — LSMGraph
exists because competing systems "suffer from read or write
amplification" — so the ledger turns the raw byte counters the store
already collects into the paper's own evaluation instruments:

  * **write amplification** — physical bytes the store wrote (WAL +
    segment files + manifest) per logical byte of ingested edge data,
    overall and per LSM level.  In-memory stores (no durability engine)
    report the logical-movement proxy instead (flush + compaction +
    index bytes — the same I/O proxy the paper's Fig 10/11 plots use).
  * **read amplification** — bytes of run records touched by the batched
    resolve per byte of adjacency actually returned, plus runs probed
    per query (the paper's "number of sorted runs consulted" metric).
  * **space amplification** — bytes on disk per logical byte of live
    edge data.  The live-edge denominator is cheap by default (inserted
    minus deleted edge counters — an upper-bound estimate under
    duplicate inserts / no-op deletes) and exact on request (one O(E)
    batched resolve).

Everything here is a pure READ of the registry: the hot paths keep
incrementing plain counters; ratios are computed only when somebody asks
(`report()`), when the ``Reporter`` refresh hook fires, or when a shard
``health_report`` renders its amplification table.  This module is
stdlib-only and duck-types the store object (``obs_label``,
``durability``, ``disk_bytes()``, ``snapshot()``) so the observability
layer stays import-free of ``repro_torch.core``.

Naming/units for derived gauges (see the package doc): family ``amp``,
suffix ``_ratio``, unit-less, REFRESHED (last-write-wins gauges), never
incremented; the overall series carries only ``store=``, per-level series
add ``level=``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .registry import MetricRegistry

#: JSON schema tag of ``AmplificationLedger.report()``.
AMP_SCHEMA = "lsmg-amp-v1"

#: Logical bytes per edge record (topology + property) — MUST mirror
#: ``core.types.BYTES_PER_EDGE + BYTES_PER_PROP`` (test-pinned in
#: tests/test_torch_obs.py; obs cannot import core).
LOGICAL_EDGE_BYTES = 20


def _default_registry() -> MetricRegistry:
    # Lazy: obs/__init__ imports this module before REGISTRY would be
    # importable at module scope.
    from . import REGISTRY
    return REGISTRY


def _ratio(num: float, den: float) -> Optional[float]:
    """None (JSON null) when the denominator is empty — a 0/0 ratio is
    "no data yet", not 0.0 (which would read as "zero amplification")."""
    return (num / den) if den > 0 else None


class AmplificationLedger:
    """Reconciles one store's registry counters into amplification ratios.

    Construction is cheap (no counters are created until read), so call
    sites may build ledgers on demand (``health_report``) or hold one and
    hand its ``refresh_gauges`` to a ``Reporter``.
    """

    def __init__(self, store, registry: Optional[MetricRegistry] = None):
        self.store = store
        self.label = store.obs_label
        self.registry = registry or _default_registry()

    # ------------------------------------------------------------- reads
    def _value(self, name: str, **labels) -> int:
        """Current value of one counter series (0 when never written —
        get-or-create keeps reads allocation-stable)."""
        return self.registry.counter(name, store=self.label, **labels).value

    def _level_bytes(self, name: str) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for inst in self.registry.find(name, store=self.label):
            lvl = inst.labels.get("level")
            if lvl is not None:
                out[lvl] = out.get(lvl, 0) + inst.value
        return out

    @property
    def physical(self) -> bool:
        """True when a durability engine is attached — physical file bytes
        exist; False = in-memory store, logical-movement proxy only."""
        return getattr(self.store, "durability", None) is not None

    # ------------------------------------------------------- write side
    def write_amplification(self) -> dict:
        logical = self._value("store_logical_ingest_bytes")
        if self.physical:
            parts = {
                "wal": self._value("io_wal_write_bytes"),
                "segment": self._value("io_segment_write_bytes"),
                "manifest": self._value("io_manifest_write_bytes"),
            }
            per_level_bytes = self._level_bytes("storage_level_write_bytes")
        else:
            parts = {
                "flush": self._value("io_flush_write_bytes"),
                "compaction": self._value("io_compaction_write_bytes"),
                "index": self._value("io_index_write_bytes"),
            }
            per_level_bytes = self._level_bytes("store_level_write_bytes")
        total = sum(parts.values())
        return {
            "mode": "physical" if self.physical else "logical",
            "logical_ingest_bytes": logical,
            "physical_bytes": dict(parts, total=total),
            "overall": _ratio(total, logical),
            "per_level": {
                lvl: {"bytes": b, "ratio": _ratio(b, logical)}
                for lvl, b in sorted(per_level_bytes.items())},
        }

    # -------------------------------------------------------- read side
    def read_amplification(self) -> dict:
        touched = self._value("io_analytics_read_bytes")
        returned = self._value("read_returned_bytes")
        queries = self._value("read_queries_total")
        probes = self._value("read_runs_probed_total")
        # Cold-load attribution: ``io_cold_load_bytes`` is THIS store's
        # evicted-segment reload traffic (the presence filters exist to
        # shrink it); the RunFile class counter stays as the process-wide
        # figure for context (loaders/recovery/scrub included).
        cold = self._value("io_cold_load_bytes")
        cold_process = self.registry.counter("read_cold_load_bytes").value
        filt_checked = self._value("read_filter_checked_total")
        filt_skipped = self._value("read_filter_skipped_total")
        return {
            "queries": queries,
            "runs_probed": probes,
            "bytes_touched": touched,
            "bytes_returned": returned,
            "cold_load_bytes": cold,
            "cold_load_bytes_process": cold_process,
            "filter_checked": filt_checked,
            "filter_skipped": filt_skipped,
            "filter_skip_ratio": _ratio(filt_skipped, filt_checked),
            "overall": _ratio(touched, returned),
            "runs_per_query": _ratio(probes, queries),
        }

    # ------------------------------------------------------- space side
    def live_edge_bytes(self, exact: bool = False) -> dict:
        """Logical bytes of live edge data.  Estimate (default): inserted
        minus deleted edge counters — exact under unique inserts and
        matched deletes, an upper bound otherwise.  ``exact=True`` pays
        one O(E) batched resolve of the whole store."""
        if exact:
            with self.store.snapshot() as snap:
                vs = snap.vertices()
                live = (int(snap.degrees_batch(vs).sum())
                        if len(vs) else 0)
            return {"bytes": live * LOGICAL_EDGE_BYTES, "estimate": False}
        ins = self._value("store_edges_inserted_total")
        dels = self._value("store_edges_deleted_total")
        return {"bytes": max(ins - dels, 0) * LOGICAL_EDGE_BYTES,
                "estimate": True}

    def space_amplification(self, exact: bool = False) -> dict:
        disk = int(self.store.disk_bytes())
        live = self.live_edge_bytes(exact=exact)
        return {
            "disk_bytes": disk,
            "live_edge_bytes": live["bytes"],
            "estimate": live["estimate"],
            "overall": _ratio(disk, live["bytes"]),
        }

    # ------------------------------------------------------------ report
    def report(self, exact_space: bool = False) -> dict:
        """The full ``lsmg-amp-v1`` document for one store."""
        return {
            "schema": AMP_SCHEMA,
            "store": self.label,
            "mode": "physical" if self.physical else "logical",
            "write": self.write_amplification(),
            "read": self.read_amplification(),
            "space": self.space_amplification(exact=exact_space),
        }

    def ratios(self) -> dict:
        """Compact {write, read, space, runs_per_query} summary — the
        per-shard amplification table ``health_report`` renders."""
        w = self.write_amplification()
        r = self.read_amplification()
        s = self.space_amplification()
        return {"write": w["overall"], "read": r["overall"],
                "space": s["overall"],
                "runs_per_query": r["runs_per_query"]}

    # ------------------------------------------------------------ gauges
    def refresh_gauges(self) -> None:
        """Recompute the ``amp_*_ratio`` gauges from the raw counters —
        the ``Reporter`` refresh hook.  Series with an empty denominator
        are REMOVED (not set to 0), matching the dead-series rule for
        level gauges."""
        reg = self.registry

        def _set(name: str, value: Optional[float], **labels) -> None:
            if value is None:
                reg.remove(name, store=self.label, **labels)
            else:
                reg.gauge(name, store=self.label, **labels).set(value)

        w = self.write_amplification()
        _set("amp_write_ratio", w["overall"])
        for lvl, ent in w["per_level"].items():
            _set("amp_write_ratio", ent["ratio"], level=lvl)
        r = self.read_amplification()
        _set("amp_read_ratio", r["overall"])
        _set("amp_read_runs_per_query", r["runs_per_query"])
        s = self.space_amplification()
        _set("amp_space_ratio", s["overall"])


def shard_amplification(shards: List[object]) -> Dict[int, dict]:
    """Per-shard compact amplification table (``health_report`` helper):
    shard ordinal -> ``ratios()`` of that shard's store."""
    return {s: AmplificationLedger(g).ratios()
            for s, g in enumerate(shards)}
