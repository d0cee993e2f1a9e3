"""What the benchmark's tests share: a small configuration of every cell
for CPU runs of a few seconds."""
#: A store and stream small enough for a CPU run of a few seconds that
#: still flushes, compacts into L1 and deeper, and deletes.
SMALL_STORE = {"vmax": 1024, "mem_edges": 1024, "seg_size": 4,
               "n_segments": 1024, "hash_slots": 4096, "ovf_cap": 4096,
               "batch_cap": 256, "level_factor": 2, "l0_run_limit": 2,
               "seg_target_edges": 1024}

SMALL = {"config": {"graph": {"scale": 10, "n_edges": 8000},
                    "stream": {"chunk": 256},
                    "store": {"config": SMALL_STORE}},
         "workload": {"warmup": {"graph": {"scale": 8, "n_edges": 1500},
                                 "full_size_calls": 3},
                      "vertices": 64, "pool": 4, "search_keys": 4,
                      "check": {"sources": 200, "deletes": 100},
                      "trace_slice": {"seconds": 0.3}}}

CELLS = ("g500-s22.ingest", "g500-s22.read-uniform", "g500-s22.analytics")

SEED = 2**31 + 977   # more than 32 signed bits hold


def run_small(cell, seed=SEED, seconds=1.0, trace=False, device="cpu",
              root=None):
    from lsmbench import spec
    from lsmbench.harness import run_cell
    return run_cell(cell, seed, seconds, trace, device,
                    root=root or spec.ROOT, overrides=SMALL,
                    log=lambda msg: None)
