"""read_p95_ms, ms (host clock): the 95th percentile of every read request
completed in the window, each timed by its client from ``snapshot()``
to ``release()``."""
from lsmbench.stats import percentile


def read(run):
    lat = run.latencies("read")
    return percentile(lat, 95) * 1e3 if lat else None
