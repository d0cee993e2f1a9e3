"""Graph analytics over LSMGraph snapshots (port of ``repro.analytics``):
PageRank, BFS, SSSP, CC and SCAN over a materialized CSR, and merge-free
PageRank over the multi-level runs."""
from .view import CSRView, RunView, materialize_csr, multilevel_views
from .algorithms import bfs, cc, pagerank, scan_stats, sssp
from .multilevel import (multilevel_degree, multilevel_pagerank,
                         multilevel_spmv)

__all__ = ["CSRView", "materialize_csr", "multilevel_views", "bfs", "cc",
           "pagerank", "scan_stats", "sssp", "multilevel_spmv",
           "multilevel_degree", "multilevel_pagerank", "RunView"]
