"""Benchmark harness — one module per paper table/figure (the port of
``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV.  BENCH_SCALE=large for paper-shaped
edge counts.  Individual benches: ``python -m
repro_torch.benchmarks.bench_update --device cpu`` etc.
``repro_torch.benchmarks.smoke`` runs every registered suite at tiny scale
as a bit-rot gate.
"""
from __future__ import annotations

import sys
import time
import traceback

from .common import cli_device


def suites() -> list:
    """(label, main) for every registered benchmark — the single registry
    the full harness, the smoke gate and the trajectory iterate.  Each
    ``main`` takes the suite's ``device``."""
    from . import (bench_analytics, bench_durability, bench_filters,
                   bench_index, bench_kernels, bench_memcache, bench_mixed,
                   bench_read_batch, bench_sharded, bench_space,
                   bench_update)
    return [
        ("fig10/11 updates", bench_update.main),
        ("fig12/13 analytics", bench_analytics.main),
        ("fig14 space", bench_space.main),
        ("fig15 memcache", bench_memcache.main),
        ("fig16/17 index", bench_index.main),
        ("fig18 mixed", bench_mixed.main),
        ("kernels", bench_kernels.main),
        ("batched reads", bench_read_batch.main),
        ("presence filters", bench_filters.main),
        ("durability", bench_durability.main),
        ("sharded scaling", bench_sharded.main),
    ]


def main(argv=None) -> None:
    device = cli_device(argv)
    print("name,us_per_call,derived")
    failures = 0
    for label, fn in suites():
        t0 = time.time()
        try:
            fn(device)
            print(f"# {label}: done in {time.time()-t0:.1f}s",
                  file=sys.stderr)
        except Exception:
            failures += 1
            print(f"# {label}: FAILED", file=sys.stderr)
            traceback.print_exc()
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
