"""run_seal_pct.ingest, % (program span): ``store_run_seal_seconds`` gained
in the window (each new run's seal in a flush or a compaction: counts
and vertex keys to the host, its presence filter), over the window.
None where the program has no such span."""

HIST = "store_run_seal_seconds"


def read(run):
    if not run.obs_count(HIST) or not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum(HIST) / run.window_s
