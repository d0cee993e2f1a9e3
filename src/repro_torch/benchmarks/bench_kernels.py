"""Kernel microbenches: each kernel's wrapper against its plain version,
wall time on the suite's device, plus the roofline-relevant derived
quantities (bytes/flops per call).  The port of
``benchmarks/bench_kernels.py``: the reference's ``kernel_*_pallas`` rows
are ``kernel_*_kernel`` here, and their ``derived`` names what the wrapper
ran (``route=cuda``: the hand-written kernel launched, as its launch count
shows; ``route=plain``: it did not, as on a CPU tensor, so on the CPU both
rows time the plain version).  ``inputs`` gives the suite's tensors, so a
caller can hold each kernel's output against its plain version at the
suite's own shapes."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..kernels import ops
from ..kernels.flash_attention import mha_ref
from ..kernels.segment_reduce import gather_segsum_ref
from .common import cli_device, emit, scale, suite_device, sync


def _bench(fn, dev, reps=3):
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) / reps


def inputs(dev) -> SimpleNamespace:
    """Both benches' inputs at the scale in force, made from seed 0."""
    smoke = scale().smoke
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    e, v = (1 << 12, 1 << 9) if smoke else (1 << 15, 1 << 12)
    seg = t(np.sort(rng.integers(0, v, e)).astype(np.int32))
    dst = t(rng.integers(0, v, e).astype(np.int32))
    wt = torch.ones((e,), dtype=torch.float32, device=dev)
    x = t(rng.normal(size=v).astype(np.float32))
    b, hq, hkv, s, d = (1, 2, 1, 128, 64) if smoke else (1, 8, 2, 512, 128)
    q = t(rng.normal(size=(b, hq, s, d)).astype(np.float32))
    k = t(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    vv = t(rng.normal(size=(b, hkv, s, d)).astype(np.float32))
    return SimpleNamespace(e=e, v=v, seg=seg, dst=dst, wt=wt, x=x, q=q, k=k,
                           vv=vv, flops=4 * b * hq * s * s * d)


def _timed_route(fn, dev, kernel):
    """``fn``'s time a call, and ``cuda`` if its calls launched
    ``kernel``, else ``plain``."""
    before = ops.launch_counts()[kernel]
    secs = _bench(fn, dev)
    return secs, ("cuda" if ops.launch_counts()[kernel] > before
                  else "plain")


def run(device=None) -> list:
    dev = suite_device(device)
    z = inputs(dev)
    rows = []
    t_k, route = _timed_route(
        lambda: ops.gather_segsum(z.dst, z.seg, z.wt, z.x, n_out=z.v), dev,
        "gather_segsum")
    t_r = _bench(lambda: gather_segsum_ref(z.dst, z.seg, z.wt, z.x, z.v),
                 dev)
    rows.append(("kernel_segsum_kernel", t_k * 1e6, f"E={z.e};route={route}"))
    rows.append(("kernel_segsum_ref", t_r * 1e6, f"E={z.e}"))

    t_k, route = _timed_route(
        lambda: ops.attention(z.q, z.k, z.vv, use_pallas=True), dev,
        "flash_attention")
    t_r = _bench(lambda: mha_ref(z.q, z.k, z.vv), dev)
    rows.append(("kernel_attn_kernel", t_k * 1e6,
                 f"flops={z.flops};route={route}"))
    rows.append(("kernel_attn_ref", t_r * 1e6, f"flops={z.flops}"))
    return rows


def main(device=None) -> None:
    emit(run(device))


if __name__ == "__main__":
    main(cli_device())
