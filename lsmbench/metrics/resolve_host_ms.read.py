"""resolve_host_ms.read, ms (program span): the mean
``read_resolve_host_seconds`` of a resolve chunk in the window (the
parts' copies to the host and the final merge there)."""

HIST = "read_resolve_host_seconds"


def read(run):
    n = run.obs_count(HIST)
    if not n or not run.done("read"):
        return None
    return run.obs_sum(HIST) / n * 1e3
