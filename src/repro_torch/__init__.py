"""repro_torch — LSMGraph ported to PyTorch, with hand-written CUDA kernels
for an NVIDIA Hopper card (sm_90a).

The JAX package ``repro`` is the reference: the port imports neither it nor
``jax``, and its tests hold each module against the reference's output on
the same inputs.  Importing the package builds nothing and needs no GPU.
"""
