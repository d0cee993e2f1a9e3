"""resolve_ms.read, ms (program span): the mean ``read_resolve_seconds``
of a resolve chunk in the window, waiting for the device and for the
other readers included."""


def read(run):
    n = run.obs_count("read_resolve_seconds")
    if not n or not run.done("read"):
        return None
    return run.obs_sum("read_resolve_seconds") / n * 1e3
