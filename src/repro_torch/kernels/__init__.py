"""Hand-written Hopper kernels of the port, with their plain versions.

``ops`` is the public surface; ``_build`` compiles ``csrc/*.cu`` at first
use.  Importing this package builds nothing and needs no GPU.
"""
