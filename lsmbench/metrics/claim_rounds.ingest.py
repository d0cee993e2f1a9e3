"""claim_rounds.ingest, rounds (program counter): the mean
``store_apply_claim_rounds`` of a chunk in the window, the MemGraph
hashmap's claim rounds, each ended by a read of a flag on the host."""

HIST = "store_apply_claim_rounds"


def read(run):
    n = run.obs_count(HIST)
    if not n or not run.done("ingest"):
        return None
    return run.obs_sum(HIST) / n
