"""The paper's competitor systems, so that Figs 10-18 compare storage
*designs*, not implementation quality (a copy of the JAX package's
``repro.baselines``).

They model the four compared systems and their I/O on the host in numpy;
the benchmarks run them beside the port's ``LSMGraph`` on the card.

  csr_inplace      — pure CSR with in-place edit (Table 1 'CSR' row /
                     LiveGraph-ish in-place behaviour): every batch rebuilds
                     the compact arrays; reads are optimal.
  lsm_kv           — RocksDB-style LSM of (src,dst)-keyed records: global
                     sorted runs, leveled compaction, NO graph layout, NO
                     multi-level index (binary search + range filters only).
  llama_snapshots  — LLAMA-style: every flush epoch emits an immutable CSR
                     delta snapshot; reads union ALL snapshots (no
                     compaction) — snapshot count grows with time.
  log_append       — MBFGraph-style append-only edge log: O(1) ingest,
                     full-log scans for every read.

All expose: insert_edges / delete_edges / snapshot_csr() -> CSRView-compatible
arrays + io-counters, the surface the benchmarks consume.
"""
from .csr_inplace import CSRInplace
from .lsm_kv import LSMKVStore
from .llama_snapshots import LlamaSnapshots
from .log_append import LogAppend

__all__ = ["CSRInplace", "LSMKVStore", "LlamaSnapshots", "LogAppend"]
