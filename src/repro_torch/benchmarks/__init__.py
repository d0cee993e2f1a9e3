"""The paper's benchmark harness on the port (the port of the reference's
top-level ``benchmarks`` package): one module per paper table/figure, each
printing ``name,us_per_call,derived`` CSV rows, with the reference's row
names (``kernel_*_pallas`` is ``kernel_*_kernel`` here).

    python -m repro_torch.benchmarks.run [--device cpu]
    python -m repro_torch.benchmarks.smoke [--device cpu]
    python -m repro_torch.benchmarks.trajectory --pr N [--device cpu]
    python -m repro_torch.benchmarks.bench_update [--device cpu]

Without ``--device`` every suite runs on the current CUDA card and fails
where there is none.  ``BENCH_SCALE=large`` gives the paper-shaped sizes,
``BENCH_SMOKE=1`` the bit-rot gate's (``common.use_scale`` in-process).
"""
