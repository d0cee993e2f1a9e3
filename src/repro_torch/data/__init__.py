"""Data generators for the port (numpy only)."""
from .graphgen import powerlaw_edges, rmat_edges, update_stream
from .synthetic import synthetic_lm_batch

__all__ = ["powerlaw_edges", "rmat_edges", "update_stream",
           "synthetic_lm_batch"]
