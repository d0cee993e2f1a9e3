"""Fig 10 (throughput) + Fig 11 (p99 latency): graph updates, insert-only and
mixed insert/delete (20:1), across all five systems (the port of
``benchmarks/bench_update.py``)."""
from __future__ import annotations

import time

from .common import (cli_device, emit, graph_edges, io_write,
                     make_systems, suite_device, sync)


def _ingest(sys_, src, dst, deletes: bool, dev):
    lat = []
    chunk = 1024
    n_del = max(1, chunk // 21)
    for off in range(0, len(src), chunk):
        s, d = src[off:off + chunk], dst[off:off + chunk]
        t0 = time.perf_counter()
        sys_.insert_edges(s, d)
        sync(dev)
        lat.append(time.perf_counter() - t0)
        if deletes and off > 0:
            ds = src[off - chunk:off - chunk + n_del]
            dd = dst[off - chunk:off - chunk + n_del]
            t0 = time.perf_counter()
            sys_.delete_edges(ds, dd)
            sync(dev)
            lat.append(time.perf_counter() - t0)
    return lat


def run(deletes: bool = False, device=None) -> list:
    dev = suite_device(device)
    src, dst = graph_edges()
    # paper protocol: first 80% forms the baseline, last 20% is measured
    cut = int(0.8 * len(src))
    rows: list = []
    for name, sys_ in make_systems(dev).items():
        _ingest(sys_, src[:cut], dst[:cut], False, dev)
        w0 = io_write(sys_)
        t0 = time.perf_counter()
        lat = _ingest(sys_, src[cut:], dst[cut:], deletes, dev)
        dt = time.perf_counter() - t0
        n = len(src) - cut
        eps = n / dt
        p99 = sorted(lat)[int(0.99 * (len(lat) - 1))] * 1e6
        tag = "mixed" if deletes else "insert"
        rows.append((f"fig10_{tag}_throughput_{name}", dt / n * 1e6,
                     f"eps={eps:.0f}"))
        rows.append((f"fig11_{tag}_p99_{name}", p99,
                     f"write_bytes={io_write(sys_) - w0}"))
    return rows


def main(device=None) -> None:
    emit(run(deletes=False, device=device))
    emit(run(deletes=True, device=device))


if __name__ == "__main__":
    main(cli_device())
