"""Shared benchmark scaffolding (the port of ``benchmarks/common.py``).

Every bench prints ``name,us_per_call,derived`` CSV rows (harness contract).
`derived` carries the figure-specific metric (edges/s, bytes, ratio...).

Scale defaults fit a 1-core CPU container; ``BENCH_SCALE=large`` gives the
paper-shaped runs (x10 edges).  ``BENCH_SMOKE=1`` shrinks every suite to a
seconds-long bit-rot gate: numbers are meaningless, only exit status and
row schema matter.  Unlike the reference, the environment is read when a
suite runs, not when this module is imported, and ``use_scale`` picks a
scale in-process (the tests and ``chip_smoke.py`` do).

Every suite's ``run``/``main`` takes ``device``: where the port's stores
and every tensor of the suite live.  ``None`` is the current CUDA card and
raises when there is none; ``--device cpu`` on a suite's command line runs
the same code with each kernel's plain version.  The baseline systems
(``repro_torch.baselines``) stay on the host in numpy.  A timed region
that launched device work ends in ``sync(device)`` before the clock is
read.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
from typing import List, Optional, Tuple

import torch

from ..core.types import resolve_device

Row = Tuple[str, float, str]


@dataclasses.dataclass(frozen=True)
class Scale:
    """The reference's sizes: 500 vertices and 6,000 edges at smoke scale,
    else 2,000 vertices and 30,000 edges, times 10 at ``large``."""

    smoke: bool = False
    scale: int = 1          # 10 at BENCH_SCALE=large

    @property
    def V(self) -> int:
        return 500 if self.smoke else 2000

    @property
    def E(self) -> int:
        return (6000 if self.smoke else 30000) * self.scale

    @classmethod
    def from_env(cls) -> "Scale":
        return cls(smoke=os.environ.get("BENCH_SMOKE") == "1",
                   scale=10 if os.environ.get("BENCH_SCALE") == "large"
                   else 1)


_PICKED: List[Scale] = []


def scale() -> Scale:
    """The scale in force: the innermost ``use_scale``, else the env."""
    return _PICKED[-1] if _PICKED else Scale.from_env()


@contextlib.contextmanager
def use_scale(sc: Scale):
    _PICKED.append(sc)
    try:
        yield sc
    finally:
        _PICKED.pop()


def suite_device(device=None) -> torch.device:
    """The suite's device (None: the current CUDA card, raising without
    one).  On a card every kernel is built and loaded here, before any
    timed row, so the first ``nvcc`` build never lands in a measurement."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from ..kernels import _build
        _build.build_all()
        for name in _build.SOURCES:
            _build.load(name)
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work before the clock is read."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cli_device(argv=None) -> Optional[str]:
    """``--device`` of a suite's command line (default: the CUDA card)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="device of the port's stores (default: the "
                         "current CUDA card; 'cpu' for the plain versions)")
    return ap.parse_args(argv).device


def emit(rows: List[Row]) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


def store_cfg():
    from ..core import StoreConfig
    return StoreConfig(
        vmax=scale().V, mem_edges=1 << 12, seg_size=8, n_segments=1 << 12,
        hash_slots=1 << 13, ovf_cap=1 << 13, batch_cap=1 << 10,
        l0_run_limit=4, seg_target_edges=1 << 13)


def make_systems(dev):
    from ..baselines import (CSRInplace, LlamaSnapshots, LogAppend,
                             LSMKVStore)
    from ..core import LSMGraph
    V = scale().V
    return {
        "lsmgraph": LSMGraph(store_cfg(), device=dev),
        "csr_inplace": CSRInplace(V),
        "lsm_kv": LSMKVStore(V, mem_cap=1 << 12),
        "llama": LlamaSnapshots(V, epoch_edges=1 << 12),
        "log_append": LogAppend(V),
    }


def graph_edges(seed=0):
    from ..data.graphgen import powerlaw_edges
    sc = scale()
    return powerlaw_edges(sc.V, sc.E, seed=seed)


def io_read(sys_) -> int:
    return sys_.io.analytics_read if hasattr(sys_.io, "analytics_read") \
        else sys_.io.read


def io_write(sys_) -> int:
    return sys_.io.total_write() if hasattr(sys_.io, "total_write") \
        else sys_.io.write
