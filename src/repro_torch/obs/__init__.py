"""repro_torch.obs — the port's metric registry.

The subset of the JAX package's ``repro.obs`` that the store uses:
counters, gauges, log-scale histograms, spans and the trace ring, on one
process-wide ``REGISTRY`` of the port's own.  Metric names and the naming
rules (``<layer>_<what>[_<unit>]``, bounded label cardinality) are the
reference's, so a dashboard reads either package the same way.
"""
from .registry import Counter, Gauge, Histogram, MetricRegistry, Span

#: The process-wide default registry every port call site uses.
REGISTRY = MetricRegistry()


def counter(name: str, **labels) -> Counter:
    return REGISTRY.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return REGISTRY.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return REGISTRY.histogram(name, **labels)


def span(name: str, **labels) -> Span:
    return REGISTRY.span(name, **labels)


__all__ = ["REGISTRY", "MetricRegistry", "Counter", "Gauge", "Histogram",
           "Span", "counter", "gauge", "histogram", "span"]
