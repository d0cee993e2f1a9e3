"""Process-wide metric registry: counters, gauges, log-scale histograms,
and the span API.

Everything here is stdlib-only and imports nothing from ``repro_torch`` —
the observability layer sits BELOW every other subsystem (core imports
``repro_torch.obs``, never the reverse), so instrumenting a module can
never create an import cycle.  A copy of the JAX package's registry: the
port keeps its own process-wide ``REGISTRY``, so a process that runs both
packages never counts one package's events under the other's series.

Thread-safety: each instrument carries its own small mutex (CPython's GIL
does not make ``+=`` atomic across the read-modify-write), and the
registry's creation map has one more for get-or-create.  Hot paths hold an
instrument lock for a few arithmetic ops only — never across I/O or device
work.

Cost model (the "near-zero when nothing is attached" contract):

  * ``Counter.inc`` / ``Gauge.set``: one lock + one add (~0.2 us);
  * ``Histogram.observe``: one ``math.log`` + one lock + array bump;
  * ``span(...)``: two ``perf_counter`` calls + one histogram observe; the
    trace ring costs ONE attribute check (``registry.trace_ring is None``)
    when tracing is disabled — events are built only while a ring is
    attached — and the profiler range one more (``_is_profiler_enabled``
    of the module ``follow_profiler`` installed): a
    ``record_function`` range is built only while ``torch.profiler``
    records.  ``tests/test_obs.py`` enforces the per-op bound.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]


class _NoProfiler:
    """Stands in for ``torch.autograd.profiler`` until ``follow_profiler``
    installs it: no profiler ever records."""

    _is_profiler_enabled = False


#: Where a span learns whether ``torch.profiler`` records
#: (``_is_profiler_enabled``) and takes the range it then enters
#: (``record_function``).
_profiler = _NoProfiler


def follow_profiler(module) -> None:
    """Make every span also a ``module.record_function`` range, named as
    the span, while ``module._is_profiler_enabled`` is true: the program's
    spans then lie on the profiler's clock, beside the device's work.
    ``repro_torch.obs`` installs ``torch.autograd.profiler``; this module
    imports nothing of torch itself."""
    global _profiler
    _profiler = module


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` only; views that need resettable reads
    (e.g. ``MergeStats``) subtract a remembered base instead of resetting
    the registry value."""

    kind = "counter"
    __slots__ = ("name", "labels", "_mu", "_value")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._mu = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._value += n

    @property
    def value(self) -> int:
        with self._mu:
            return self._value


class Gauge:
    """Last-write-wins instantaneous value (depths, queue lengths, 0/1
    health flags)."""

    kind = "gauge"
    __slots__ = ("name", "labels", "_mu", "_value")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._mu = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._mu:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._mu:
            self._value -= n

    @property
    def value(self) -> float:
        with self._mu:
            return self._value


class Histogram:
    """Fixed-bucket log-scale histogram with percentile extraction.

    Buckets are geometric: ``buckets_per_decade`` per power of ten over
    ``[lo, hi)``, plus implicit under/overflow clamping into the edge
    buckets.  A reported percentile is the geometric midpoint of the bucket
    the cumulative count crosses — relative error is bounded by half a
    bucket ratio (``10 ** (0.5 / buckets_per_decade)``, ~6% at the default
    20/decade), which the accuracy test checks against numpy.

    The defaults suit seconds-valued latencies (100 ns .. 1000 s); size-
    valued histograms (batch sizes, fan-outs) pass ``lo=1``.  Standalone
    construction (no registry) is supported so benchmarks can reuse the
    same percentile math as production metrics."""

    kind = "histogram"
    __slots__ = ("name", "labels", "lo", "hi", "buckets_per_decade",
                 "_mu", "_counts", "_log_lo", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, name: str, labels: Optional[Dict[str, str]] = None, *,
                 lo: float = 1e-7, hi: float = 1e3,
                 buckets_per_decade: int = 20):
        assert lo > 0 and hi > lo
        self.name = name
        self.labels = dict(labels or {})
        self.lo = lo
        self.hi = hi
        self.buckets_per_decade = buckets_per_decade
        self._log_lo = math.log10(lo)
        n = int(math.ceil((math.log10(hi) - self._log_lo)
                          * buckets_per_decade))
        self._mu = threading.Lock()
        self._counts = [0] * max(n, 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        i = int((math.log10(x) - self._log_lo) * self.buckets_per_decade)
        return min(i, len(self._counts) - 1)

    def observe(self, x: float) -> None:
        x = float(x)
        i = self._bucket(x) if x > 0 else 0
        with self._mu:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x

    # ------------------------------------------------------------- reads
    @property
    def count(self) -> int:
        with self._mu:
            return self._count

    @property
    def sum(self) -> float:
        with self._mu:
            return self._sum

    @property
    def min(self) -> float:
        with self._mu:
            return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        with self._mu:
            return self._max if self._count else 0.0

    def _bucket_mid(self, i: int) -> float:
        return 10.0 ** (self._log_lo + (i + 0.5) / self.buckets_per_decade)

    def percentile(self, p: float) -> float:
        """Estimate the p-th percentile (p in [0, 100]): the geometric
        midpoint of the bucket where the cumulative count crosses
        ``p/100 * count``, clamped into the observed [min, max]."""
        return self.percentiles([p])[0]

    def percentiles(self, ps) -> List[float]:
        """Batch percentile extraction under one lock acquisition."""
        with self._mu:
            total = self._count
            if total == 0:
                return [0.0 for _ in ps]
            counts = list(self._counts)
            mn, mx = self._min, self._max
        out = []
        for p in ps:
            need = max(1, math.ceil(p / 100.0 * total))
            cum = 0
            val = self._bucket_mid(len(counts) - 1)
            for i, c in enumerate(counts):
                cum += c
                if cum >= need:
                    val = self._bucket_mid(i)
                    break
            out.append(min(max(val, mn), mx))
        return out

    def snapshot(self) -> dict:
        """Point-in-time summary (the exporter's read surface)."""
        with self._mu:
            total = self._count
            summary = {
                "count": total,
                "sum": self._sum,
                "min": self._min if total else 0.0,
                "max": self._max if total else 0.0,
            }
        p50, p99, p999 = self.percentiles([50, 99, 99.9])
        summary.update(p50=p50, p99=p99, p999=p999)
        return summary


class Span:
    """Timed scope: ``with registry.span("store_flush", store="s0"): ...``
    records the duration into the ``<name>_seconds`` histogram and — only
    while a trace ring is attached — appends a trace event carrying name,
    labels, thread, nesting depth, wall window, and outcome.

    While ``torch.profiler`` records (``follow_profiler``), the span is
    also a ``record_function`` range of its name, without labels, so the
    profiler's trace shows it around the host work and the device work it
    launches.

    A span that exits via an exception records ``ok: False`` on its trace
    event and bumps ``<name>_errors_total`` (same labels), so failed
    flushes/compactions are visible in both traces and counters; the
    exception itself always propagates."""

    __slots__ = ("_reg", "_hist", "name", "labels", "t0", "duration",
                 "_depth", "ok", "_range")

    def __init__(self, reg: "MetricRegistry", hist: Histogram, name: str,
                 labels: Dict[str, str]):
        self._reg = reg
        self._hist = hist
        self.name = name
        self.labels = labels
        self.t0 = 0.0
        self.duration = 0.0
        self._depth = 0
        self.ok = True
        self._range = None

    def __enter__(self) -> "Span":
        if self._reg.trace_ring is not None:  # the one hot-path check
            tls = self._reg._tls
            self._depth = getattr(tls, "depth", 0)
            tls.depth = self._depth + 1
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        dt = time.perf_counter() - self.t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        self.duration = dt
        self._hist.observe(dt)
        if exc_type is not None:
            # Error path only: the registry map lookup is fine here — a
            # failing span is never the hot path.
            self.ok = False
            self._reg.counter(self.name + "_errors_total",
                              **self.labels).inc()
        ring = self._reg.trace_ring
        if ring is not None:
            tls = self._reg._tls
            tls.depth = max(getattr(tls, "depth", 1) - 1, 0)
            ring.append({
                "name": self.name, "labels": dict(self.labels),
                "t0": self.t0, "dur": dt, "depth": self._depth,
                "thread": threading.current_thread().name,
                "ok": exc_type is None,
            })


class MetricRegistry:
    """Get-or-create instrument map keyed by (name, sorted labels).

    One process-wide default lives at ``repro.obs.REGISTRY``; tests build
    private instances.  Creation is locked; created instruments are handed
    back by reference so call sites cache them and the hot path never
    touches the registry map."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelKey], object] = {}
        # Bounded in-memory trace ring; None = tracing disabled (the span
        # hot path checks exactly this attribute).
        self.trace_ring: Optional[deque] = None
        self._tls = threading.local()

    def _get_or_create(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        inst = self._metrics.get(key)
        if inst is None:
            with self._mu:
                inst = self._metrics.get(key)
                if inst is None:
                    inst = cls(name, labels, **kw)
                    self._metrics[key] = inst
        if not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels)

    def histogram(self, name: str, *, lo: float = 1e-7, hi: float = 1e3,
                  buckets_per_decade: int = 20, **labels) -> Histogram:
        return self._get_or_create(Histogram, name, labels, lo=lo, hi=hi,
                                   buckets_per_decade=buckets_per_decade)

    def span(self, name: str, **labels) -> Span:
        hist = self.histogram(name + "_seconds", **labels)
        return Span(self, hist, name, labels)

    def remove(self, name: str, **labels) -> bool:
        """Drop one series (exact name + labels) from the registry so
        exporters stop reporting it — the dead-series lever for gauges
        whose subject disappears (e.g. ``store_level_runs`` for a level
        emptied by a full compaction).  Call sites that cached the
        instrument reference may keep writing to it harmlessly; a later
        get-or-create registers a FRESH instrument.  Returns True iff a
        series was removed."""
        key = (name, _label_key(labels))
        with self._mu:
            return self._metrics.pop(key, None) is not None

    def find(self, name: str, **labels) -> List[object]:
        """Every registered instrument with ``name`` whose labels are a
        superset of ``labels`` — the read surface for derived-metric
        ledgers that aggregate one metric across label values (e.g. all
        ``storage_level_write_bytes`` series of one store)."""
        with self._mu:
            insts = [inst for (n, _k), inst in self._metrics.items()
                     if n == name]
        return [inst for inst in insts
                if all(inst.labels.get(k) == str(v)
                       for k, v in labels.items())]

    # ------------------------------------------------------------ tracing
    def trace_instant(self, name: str, **labels) -> None:
        """Record a zero-duration lifecycle event (flush rotate/commit,
        compaction commit, quarantine, fence...) into the trace ring.
        Exactly one attribute check when tracing is disabled — safe to
        leave on cold paths unconditionally."""
        ring = self.trace_ring
        if ring is None:
            return
        ring.append({
            "name": name, "labels": {k: str(v) for k, v in labels.items()},
            "t0": time.perf_counter(), "dur": None,
            "depth": getattr(self._tls, "depth", 0),
            "thread": threading.current_thread().name, "ok": True,
        })

    def enable_tracing(self, capacity: int = 4096) -> None:
        """Attach a bounded trace ring; spans start recording events."""
        self.trace_ring = deque(maxlen=capacity)

    def disable_tracing(self) -> None:
        self.trace_ring = None

    def trace_events(self) -> List[dict]:
        """Copy of the ring (oldest first); empty when tracing is off."""
        ring = self.trace_ring
        return list(ring) if ring is not None else []

    # ------------------------------------------------------------- export
    def collect(self) -> List[object]:
        """Every registered instrument, sorted by (name, labels) — the
        stable iteration order both exporters share."""
        with self._mu:
            items = list(self._metrics.items())
        items.sort(key=lambda kv: kv[0])
        return [inst for _key, inst in items]
