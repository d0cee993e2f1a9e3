"""analytics_ms, ms (host clock): the window over the analytics requests
completed in it."""


def read(run):
    n = len(run.done("analytics"))
    return run.window_s / n * 1e3 if n else None
