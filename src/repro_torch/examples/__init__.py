"""The reference's examples on the port (``examples/``), as modules:

    python -m repro_torch.examples.quickstart [--device cpu]
    python -m repro_torch.examples.streaming_updates [--device cpu]

Without ``--device`` they run on the current CUDA card and fail where
there is none.
"""
