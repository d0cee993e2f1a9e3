"""Export the span trace ring as Chrome trace-event / Perfetto JSON.

The port of ``repro.obs.trace_export``: the same document, from the
port's own ``REGISTRY``.

The registry's trace ring (``MetricRegistry.enable_tracing``) buffers
completed spans — flushes, compactions, WAL fsyncs, batched resolves —
and point lifecycle events (``trace_instant``: flush rotate/commit,
compaction commit, quarantine, rebuild, WAL rotate, shard fence).  This
module converts that ring into the Chrome trace-event JSON format
(https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
so a mixed ingest+read run opens as a flamegraph-able timeline in
Perfetto (ui.perfetto.dev) or ``chrome://tracing``:

* spans become duration events (``ph: "X"``) on one track per thread,
  nested by their recorded depth;
* instants become ``ph: "i"`` thread-scoped markers;
* each thread gets a ``ph: "M"`` thread_name metadata record;
* labels ride in ``args`` (plus ``ok: false`` on spans that exited via
  exception — Perfetto's search surfaces them instantly);
* the event ``cat`` is the metric family (first ``_`` token), so whole
  layers toggle on/off in the UI.

Timestamps are ``time.perf_counter`` seconds with an arbitrary epoch;
they are rebased to the earliest buffered event and emitted in integer
microseconds (the format's unit).  Stdlib-only, read-only over the ring:
exporting never perturbs what it measures.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

from .registry import MetricRegistry


def to_chrome_trace(registry: Optional[MetricRegistry] = None,
                    events: Optional[List[dict]] = None) -> dict:
    """Build the Chrome trace-event document from ``registry``'s ring (or
    an explicit ``events`` list — the ring's dicts — for testing).
    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms"}``; empty
    ring (or tracing disabled) yields an empty ``traceEvents``."""
    if events is None:
        if registry is None:
            from . import REGISTRY
            registry = REGISTRY
        ring = registry.trace_ring
        events = list(ring) if ring is not None else []
    pid = os.getpid()
    out: List[dict] = []
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t_base = min(e["t0"] for e in events)
    tids: dict = {}
    for e in events:
        thread = e.get("thread", "?")
        tid = tids.get(thread)
        if tid is None:
            tid = tids[thread] = len(tids) + 1
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": thread}})
        name = e["name"]
        cat = name.partition("_")[0]
        args = dict(e.get("labels") or {})
        if "depth" in e:
            args["depth"] = e["depth"]
        if not e.get("ok", True):
            args["ok"] = False
        ts_us = int(round((e["t0"] - t_base) * 1e6))
        ev = {"name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": ts_us, "args": args}
        dur = e.get("dur")
        if dur is None:
            ev.update(ph="i", s="t")       # thread-scoped instant
        else:
            ev.update(ph="X", dur=max(int(round(dur * 1e6)), 1))
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str,
                        registry: Optional[MetricRegistry] = None) -> int:
    """Write the ring as a Chrome trace JSON file (the ``graph_service
    --trace FILE`` backend).  Returns the number of non-metadata events
    written."""
    doc = to_chrome_trace(registry)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return sum(1 for e in doc["traceEvents"] if e["ph"] != "M")
