"""apply_place_pct.ingest, % (program span): ``store_apply_place_seconds``
gained in the window (rank within row, the segment and overflow scatters
of each chunk), over the window.  None where the program has no such
span."""

HIST = "store_apply_place_seconds"


def read(run):
    if not run.obs_count(HIST) or not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum(HIST) / run.window_s
