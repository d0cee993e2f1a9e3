"""Data generators for the port (numpy only)."""
from .graphgen import powerlaw_edges, rmat_edges, update_stream

__all__ = ["powerlaw_edges", "rmat_edges", "update_stream"]
