"""Entry points of the port (the graph service)."""
