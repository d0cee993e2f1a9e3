"""view_collect_ms.analytics, ms (program span):
``analytics_view_collect_seconds`` gained in the window (the runs'
record tensors and the loop over them, inside ``materialize_csr``), over
the window's analytics requests."""

HIST = "analytics_view_collect_seconds"


def read(run):
    n = len(run.done("analytics"))
    if not n or not run.obs_count(HIST):
        return None
    return run.obs_sum(HIST) / n * 1e3
