"""ingest_rate, records/s (host clock): records whose ``insert_edges`` or
``delete_edges`` call returned in the window, over the whole window."""
from lsmbench.stats import rate


def read(run):
    n = run.units("ingest")
    return rate(n, run.window_s) if n else None
