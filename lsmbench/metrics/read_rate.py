"""read_rate, vertices/s (host clock): adjacency lists returned to every
reader in the window, over the whole window."""
from lsmbench.stats import rate


def read(run):
    n = run.units("read")
    return rate(n, run.window_s) if n else None
