"""materialize_ms.analytics, ms (benchmark span, ends in a synchronize):
``materialize_csr`` a request, the mean over the window's requests."""


def read(run):
    s = run.spans.seconds.get("analytics.materialize_csr")
    return sum(s) / len(s) * 1e3 if s else None
