"""The plain reference the benchmark holds the program to: last-writer-wins
adjacency and the analytics, in plain torch, from the benchmark's own
stream.  It imports nothing of the program and takes nothing the program
made."""
from .lww import adjacency_of, lww_csr
from .algorithms import bfs_hops, pagerank, sssp

__all__ = ["lww_csr", "adjacency_of", "pagerank", "bfs_hops", "sssp"]
