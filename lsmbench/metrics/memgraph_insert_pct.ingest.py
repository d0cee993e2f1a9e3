"""memgraph_insert_pct.ingest, % (program span): the store's
``store_apply_seconds`` gained in the window (each MemGraph insert of a
call, ending in a copy to the host), over the window."""


def read(run):
    if not run.done("ingest"):
        return None
    return 100.0 * run.obs_sum("store_apply_seconds") / run.window_s
