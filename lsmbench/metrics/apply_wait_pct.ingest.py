"""apply_wait_pct.ingest, % (program span): ``store_apply_wait_seconds``
gained in the window (the host's wait in ``bool(ok)`` for each chunk's
device work), over the window.  None where the program has no such span."""

HIST = "store_apply_wait_seconds"


def read(run):
    if not run.obs_count(HIST) or not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum(HIST) / run.window_s
