"""Entry points of the port (the graph service, the mesh and LM serving)."""
