"""repro_torch.obs — the port's store-wide observability layer.

A copy of the JAX package's ``repro.obs`` on a process-wide ``REGISTRY`` of
the port's own, so a process that runs both packages never counts one
package's events under the other's series.  Metric names, the naming
rules, the JSON and Prometheus schemas and the trace format are the
reference's, so a dashboard reads either package the same way.

One process-wide ``MetricRegistry`` (``REGISTRY``) holds every counter,
gauge, and latency histogram in the system; ``span(...)`` times scopes
into duration histograms and, when tracing is enabled, a bounded
in-memory trace ring.  ``export_json``/``export_prometheus`` snapshot the
whole registry; ``Reporter`` does so periodically.  The compaction
scheduler and the graph service read from here rather than growing
their own ad-hoc state.

Observability model
===================

**Naming.** ``<layer>_<what>[_<unit>]``, lower_snake_case.  The first
token is the owning layer and becomes the family in the hierarchical
JSON export.  Counters of discrete events end in ``_total``; byte
counters in ``_bytes``; duration histograms in ``_seconds`` (``span``
appends it automatically); unit-less gauges (depths, 0/1 flags) carry no
unit suffix.

**Layer ownership.**  A metric is registered and written by exactly one
layer — readers go through the exporter, never by reaching into another
layer's instruments:

* ``store_*``  — core/store.py + core/concurrent.py (+ core/memgraph.py
  for the insert's steps): apply/flush/compaction spans,
  ``store_state_publish_total``, ``store_l0_depth`` and
  ``store_level_runs`` gauges, background-thread error counts.  The
  apply's steps are child spans of ``store_apply``: ``store_apply_upload``
  (padding and the chunk's host-to-device copies),
  ``store_apply_claim`` (the dedup and the hashmap's claim rounds, one
  kernel launch on the card, which reads nothing to the host; no labels,
  the store is not at hand in ``memgraph.py``),
  ``store_apply_place`` (rank within row, the segment and overflow
  scatters; no labels) and ``store_apply_wait`` (the read of ``ok`` and
  the claim rounds, where the host waits for the insert's device work),
  with the histogram ``store_apply_claim_rounds`` (rounds a chunk, no
  labels, observed after that read).  A
  compaction's ``csr.merge_runs`` is ``store_compaction_merge``; a run's
  sealing (``_wrap``: counts and vertex keys to the host, the presence
  filter) is ``store_run_seal``, inside a flush or a compaction.  The
  ablation modes (``memcache_mode``) time no steps.
* ``storage_*`` — storage/wal.py + storage/engine.py: WAL append/fsync
  latency, group-commit batch size, segment write/load/evict, scrubber
  verdicts, quarantine counts.
* ``shard_*``  — shard/store.py: per-shard fencing state, ack latency,
  degraded-range count, routed-batch fan-out.
* ``read_*``   — the read path (core/store.py resolve + core/types.py
  prefetch): resolve batch latency (``read_resolve``, with its steps
  ``read_resolve_sealed`` — query upload to the sealed tier's parts —,
  ``read_resolve_mem`` — the active MemGraph and the suppression of
  sealed winners — and ``read_resolve_host`` — the parts to the host and
  the final merge there), prefetch hit/miss, and the presence-
  filter counters — ``read_filter_checked_total`` ((run, query) pairs
  tested against a run's vertex-presence filter),
  ``read_filter_skipped_total`` (pairs the filter proved absent — device
  work and, on the per-run paths, cold segment loads avoided),
  ``read_filter_false_positive_total`` (filter said "maybe", the gather
  found nothing; observable on the scalar path only).  All three carry
  ``store=``; skipped/checked is the filter's live selectivity, and
  false-positive/checked calibrates the bits-per-key budget.
* ``compaction_*`` — shard/scheduler.py: the amplification-driven
  scheduler's decision stream.  ``compaction_sched_decision_total``
  (``decision=`` ``compact`` | ``skip_hot`` | ``skip_backoff`` | ``idle``
  — a closed enum), ``compaction_sched_compactions_total`` (``shard=``),
  and the ``compaction_sched_interval_seconds`` gauge tracking the
  backoff-widened tick.  Written only by the scheduler thread.
* ``analytics_*`` — analytics/view.py: ``materialize_csr``'s record
  collection (``analytics_view_collect``: the MemGraph tiers sorted and
  every source laid end to end, with no host read) and its merge
  (``analytics_view_merge``: the one tournament over them, a
  ``merge_pairs`` launch a round on the card), both with ``store=``;
  ``analytics_view_sources_total`` (``store=``) counts the sources a
  build merges (the MemGraph tiers and every sealed run with a vertex).
* ``io_*``     — the ``IOCounters`` mirror (core/types.py): byte counters
  kept byte-compatible with the legacy dataclass API.
* ``merge_*``  — the ``MERGE_STATS`` view (kernels/merge.py): kernel-vs-
  host merge branch counts, spine build/splice/reuse.
* ``amp_*``    — derived amplification gauges (obs/amplification.py):
  written ONLY by ``AmplificationLedger.refresh_gauges`` — never by a
  hot path.

**Derived metrics (amplification).**  ``obs/amplification.py`` turns raw
counters into the paper's evaluation ratios: write amplification
(physical WAL + segment + manifest bytes ÷ ``store_logical_ingest_bytes``,
overall and per level via ``storage_level_write_bytes``; in-memory
stores use the flush/compaction/index logical proxy), read amplification
(``io_analytics_read_bytes`` touched ÷ ``read_returned_bytes``, plus
``read_runs_probed_total``/``read_queries_total`` runs-per-query), and
space amplification (``disk_bytes()`` ÷ live edge bytes).  Rules for
ratio gauges: family ``amp``, suffix ``_ratio`` (the one sanctioned
unit-less suffix — a ratio IS the unit), runs-per-query gauges carry no
suffix; values are REFRESHED from counters (``refresh_gauges``, hooked
into ``Reporter``), never incremented; an empty-denominator series is
REMOVED (``MetricRegistry.remove``), not set to 0 — "no data" must not
export as "no amplification".  The JSON report form is schema
``lsmg-amp-v1`` (``AmplificationLedger.report``).

**Dead series.**  A gauge whose subject disappears (a level emptied by a
full compaction, a ratio losing its denominator) is removed via
``MetricRegistry.remove`` at the owning commit point, so exporters stop
reporting it; stale last values never outlive their subject.

**Trace export.**  With tracing enabled (``REGISTRY.enable_tracing``),
spans land in the bounded ring together with point lifecycle events
(``trace_instant``: flush rotate/commit, compaction commit, WAL rotate,
quarantine, rebuild, shard fence).  ``obs/trace_export.py`` converts the
ring to Chrome trace-event / Perfetto JSON (spans → ``ph:"X"`` duration
events per thread, instants → ``ph:"i"`` markers, families → ``cat``,
failed spans carry ``args.ok: false``); ``graph_service --trace FILE``
writes it at exit.  Independently of the ring, while ``torch.profiler``
records, every span is also a ``record_function`` range named as the
span (labels left out), so the profiler's trace nests the program's
spans with the host ops and device work they cover on one clock.  No
span synchronizes: a span's host time includes only the waits the code
already has; device time comes from the device trace.

**Label cardinality.**  Labels multiply series; every label must be
bounded by configuration, never by data.  Allowed: store ordinal
(``store="s0"``), shard index (``shard="3"``), level (``level="1"``),
small closed enums (``verdict="healed"``).  Forbidden: vertex ids, seq
numbers, file ids, timestamps — anything that grows with the workload
belongs in a histogram observation or a trace event, not a label.

**Cost.**  Instruments are cached at call sites (module- or
instance-level attributes), so hot paths pay one lock + one add — never
a registry map lookup.  The span hot path pays two ``perf_counter``
calls and one histogram observe; the trace ring adds exactly one
attribute check while disabled, and so does the profiler range (plus one
``None`` check on exit); the range is built only while a profiler
records.  ``tests/test_torch_obs.py`` enforces
the per-op bound and the < 2% ingest overhead budget.
"""
import torch.autograd.profiler as _torch_profiler

from .registry import (Counter, Gauge, Histogram, MetricRegistry, Span,
                       follow_profiler)
from .export import SCHEMA, Reporter, export_json, export_prometheus

follow_profiler(_torch_profiler)

#: The process-wide default registry every production call site uses.
REGISTRY = MetricRegistry()

# Derived layers import lazily-resolved REGISTRY, so they must come after
# its definition.
from .amplification import (AMP_SCHEMA, AmplificationLedger,  # noqa: E402
                            shard_amplification)
from .trace_export import (export_chrome_trace,               # noqa: E402
                           to_chrome_trace)


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def span(name: str, **labels) -> Span:
    return REGISTRY.span(name, **labels)


__all__ = [
    "REGISTRY", "SCHEMA", "AMP_SCHEMA", "MetricRegistry", "Counter",
    "Gauge", "Histogram", "Span", "Reporter", "AmplificationLedger",
    "export_json", "export_prometheus", "export_chrome_trace",
    "to_chrome_trace", "shard_amplification",
    "counter", "gauge", "histogram", "span",
]
