"""Exporters over a ``MetricRegistry``: hierarchical JSON, prometheus-style
text, and a periodic reporter thread.

The port of ``repro.obs.export``, with the reference's schema strings and
label escaping, so a dashboard reads either package's exports the same way.

The JSON document is the contract the smoke test and ``graph_service
--metrics`` validate against:

    {"schema": "lsmg-metrics-v1",
     "families": {
       "store": {"flush_seconds": [{"labels": {...}, "type": "histogram",
                                    "count": 3, "p50": ..., ...}], ...},
       "io":    {"wal_write_bytes": [{"labels": {...}, "type": "counter",
                                      "value": 4096}]},
       ...}}

A metric named ``store_flush_seconds`` files under family ``store`` (the
first ``_``-separated token — by convention the owning layer) with the
rest as the in-family key, which is what makes the report hierarchical
rather than a flat dump."""
from __future__ import annotations

import json
import sys
import threading
from typing import Callable, Optional, Sequence, TextIO

from .registry import Counter, Gauge, Histogram, MetricRegistry

SCHEMA = "lsmg-metrics-v1"


def _entry(inst) -> dict:
    e = {"labels": dict(inst.labels), "type": inst.kind}
    if isinstance(inst, Histogram):
        e.update(inst.snapshot())
    else:
        e["value"] = inst.value
    return e


def export_json(registry: MetricRegistry) -> dict:
    """Hierarchical snapshot of every registered instrument."""
    families: dict = {}
    for inst in registry.collect():
        family, _, rest = inst.name.partition("_")
        key = rest or family
        families.setdefault(family, {}).setdefault(key, []).append(
            _entry(inst))
    return {"schema": SCHEMA, "families": families}


def _escape_label_value(v: str) -> str:
    """Label-value escaping per the Prometheus text exposition format:
    backslash, double-quote, and line-feed must be escaped or a hostile
    value (a path, an error string) breaks the whole scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP-text escaping: backslash and line-feed only (quotes are legal
    in HELP lines)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(v)}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def export_prometheus(registry: MetricRegistry,
                      help_text: Optional[dict] = None) -> str:
    """Prometheus-style text exposition (counters/gauges as-is; histograms
    as _count/_sum plus quantile gauges — a summary, not cumulative
    buckets, which is all our fixed-bucket design needs downstream).
    ``help_text`` optionally maps metric name -> HELP line; label values
    and HELP text are escaped per the exposition format."""
    lines = []
    seen_types = set()
    help_text = help_text or {}
    for inst in registry.collect():
        lab = _fmt_labels(inst.labels)
        if inst.name not in seen_types and inst.name in help_text:
            lines.append(
                f"# HELP {inst.name} {_escape_help(help_text[inst.name])}")
        if isinstance(inst, Histogram):
            if inst.name not in seen_types:
                lines.append(f"# TYPE {inst.name} summary")
                seen_types.add(inst.name)
            snap = inst.snapshot()
            lines.append(f"{inst.name}_count{lab} {snap['count']}")
            lines.append(f"{inst.name}_sum{lab} {snap['sum']:.9g}")
            for q, key in ((0.5, "p50"), (0.99, "p99"), (0.999, "p999")):
                qlab = dict(inst.labels, quantile=str(q))
                lines.append(
                    f"{inst.name}{_fmt_labels(qlab)} {snap[key]:.9g}")
        else:
            kind = "counter" if isinstance(inst, Counter) else "gauge"
            if inst.name not in seen_types:
                lines.append(f"# TYPE {inst.name} {kind}")
                seen_types.add(inst.name)
            lines.append(f"{inst.name}{lab} {inst.value:.9g}"
                         if isinstance(inst, Gauge)
                         else f"{inst.name}{lab} {inst.value}")
    return "\n".join(lines) + "\n"


class Reporter:
    """Daemon thread that periodically hands a fresh JSON export to
    ``sink`` (default: compact JSON line to stderr).  ``stop()`` joins;
    a final report is emitted on stop so short runs still see one.

    ``refresh`` callbacks run before every export — the hook derived-
    metric ledgers (``obs.amplification``) use to recompute their ratio
    gauges from the raw counters, so every emitted report carries current
    amplification numbers without the hot paths ever computing a ratio.
    A refresh callback that raises is dropped from subsequent rounds
    (reported once to stderr) rather than killing the reporter."""

    def __init__(self, registry: MetricRegistry, interval: float = 10.0,
                 sink: Optional[Callable[[dict], None]] = None,
                 stream: Optional[TextIO] = None,
                 refresh: Optional[Sequence[Callable[[], None]]] = None):
        self._registry = registry
        self._interval = interval
        stream = stream or sys.stderr
        self._sink = sink or (lambda doc: print(
            json.dumps(doc, sort_keys=True), file=stream, flush=True))
        self._refresh = list(refresh or [])
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="obs-reporter", daemon=True)

    def add_refresh(self, cb: Callable[[], None]) -> "Reporter":
        self._refresh.append(cb)
        return self

    def _export(self) -> dict:
        for cb in list(self._refresh):
            try:
                cb()
            except Exception as e:          # noqa: BLE001 — keep reporting
                self._refresh.remove(cb)
                print(f"obs.Reporter: refresh callback {cb!r} dropped "
                      f"after error: {e!r}", file=sys.stderr)
        return export_json(self._registry)

    def start(self) -> "Reporter":
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self._sink(self._export())

    def stop(self) -> None:
        if not self._stop.is_set():
            self._stop.set()
            self._thread.join()
            self._sink(self._export())
