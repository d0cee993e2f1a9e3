#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 lsmbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Needs a CUDA card (exit code 2 without one).  Reads ``BENCHMARK.json`` at
the root of the checkout and the port in ``src/repro_torch``.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# The benchmark's modules are imported as ``lsmbench.*``: its own folder
# leaves the path, so that none of them shadows a module of the same name.
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]

from lsmbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
