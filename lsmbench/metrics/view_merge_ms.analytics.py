"""view_merge_ms.analytics, ms (program span):
``analytics_view_merge_seconds`` gained in the window (the tournament,
or the concatenation and its sort, inside ``materialize_csr``), over the
window's analytics requests."""

HIST = "analytics_view_merge_seconds"


def read(run):
    n = len(run.done("analytics"))
    if not n or not run.obs_count(HIST):
        return None
    return run.obs_sum(HIST) / n * 1e3
