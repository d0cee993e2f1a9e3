"""compaction_merge_pct.ingest, % (program span):
``store_compaction_merge_seconds`` gained in the window (each
compaction's ``csr.merge_runs``), over the window.  None where the
program has no such span."""

HIST = "store_compaction_merge_seconds"


def read(run):
    if not run.obs_count(HIST) or not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum(HIST) / run.window_s
