"""resolve_mem_ms.read, ms (program span): the mean
``read_resolve_mem_seconds`` of a resolve chunk in the window (the
active MemGraph's records and the suppression of sealed winners)."""

HIST = "read_resolve_mem_seconds"


def read(run):
    n = run.obs_count(HIST)
    if not n or not run.done("read"):
        return None
    return run.obs_sum(HIST) / n * 1e3
