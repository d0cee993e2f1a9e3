"""apply_claim_pct.ingest, % (program span): ``store_apply_claim_seconds``
gained in the window (``torch.unique`` and the hashmap's claim rounds of
each chunk), over the window.  None where the program has no such span."""

HIST = "store_apply_claim_seconds"


def read(run):
    if not run.obs_count(HIST) or not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum(HIST) / run.window_s
