"""resolve_sealed_ms.read, ms (program span): the mean
``read_resolve_sealed_seconds`` of a resolve chunk in the window (the
query upload to the sealed tier's live records)."""

HIST = "read_resolve_sealed_seconds"


def read(run):
    n = run.obs_count(HIST)
    if not n or not run.done("read"):
        return None
    return run.obs_sum(HIST) / n * 1e3
