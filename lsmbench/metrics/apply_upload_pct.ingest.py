"""apply_upload_pct.ingest, % (program span):
``store_apply_upload_seconds`` gained in the window (padding and the
host-to-device copies of each chunk), over the window.  None where the
program has no such span."""

HIST = "store_apply_upload_seconds"


def read(run):
    if not run.obs_count(HIST) or not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum(HIST) / run.window_s
