"""flush_compaction_pct.ingest, % (program span): ``store_flush_seconds``
and ``store_compaction_seconds`` (every level) gained in the window, over
the window."""


def read(run):
    if not run.done("ingest"):
        return None
    busy = (run.obs_sum("store_flush_seconds")
            + run.obs_sum("store_compaction_seconds"))
    return 100.0 * busy / run.window_s
