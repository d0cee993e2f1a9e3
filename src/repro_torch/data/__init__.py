"""Data generators for the port (numpy only)."""
from .graphgen import rmat_edges, update_stream

__all__ = ["rmat_edges", "update_stream"]
