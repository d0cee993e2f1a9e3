"""The benchmark of the PyTorch and CUDA port of LSMGraph (``repro_torch``).

``python3 lsmbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line; see ``lsmbench/README.md``.
"""
