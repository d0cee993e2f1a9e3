#!/usr/bin/env python3
"""Time the single-run segment kernels of ``src/repro_torch/csrc/
segment_reduce.cu`` on one NVIDIA GPU at the analytics path's shape.

    python3 tools/segment_bench.py [--parent FILE.cu] [--o0] [--seed N]

The CSR is Graph500 R-MAT scale 22 (A/B/C = 0.57/0.19/0.19, no vertex
permutation, as ``repro_torch.data.rmat_edges`` draws it), generated on the
card: the distinct edges of 1.06 x 2**26 draws, 64,060,967 of them kept at
random (the live edge count of ``chip_smoke.py``'s store at seed 0),
sorted by (src, dst).  segsum runs on integer inputs (wt in {1, -1, 0, 2},
x in [-2, 2]: every partial sum is exact), segmin on weights uniform in
[0, 1) and x uniform in [0, 10), as in ``chip_smoke.py`` phase 4.

For each kernel it prints the check against the plain version, the times of
``chip_smoke.segment_times`` (CUDA events; device time of all kernels and
of the reduction alone by ``torch.profiler``; the dst = 0 and dst = seg_id
probes) and the byte bound.  ``--parent FILE.cu`` builds an earlier
``segment_reduce.cu`` with the same C interface under another library name
and times it against the checkout's in turns: parent, new, new, parent,
each by CUDA events.  ``--o0`` builds the checkout's source at
``-Xptxas -O0`` as well and holds both builds against the plain version:
a loop that ptxas compiles wrongly at -O1 and above shows there.  Fails
without a card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

LIVE_EDGES = 64_060_967


def rmat_csr(dev, seed: int):
    """(dst, seg_id) int32 of the R-MAT scale-22 CSR described above."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a, b, c = 0.57, 0.19, 0.19
    draw = int((cs.EDGEFACTOR << cs.SCALE) * 1.06)
    src = torch.zeros(draw, dtype=torch.int64, device=dev)
    dst = torch.zeros(draw, dtype=torch.int64, device=dev)
    for _ in range(cs.SCALE):
        r = torch.rand(draw, generator=gen, device=dev)
        src = (src << 1) | (r > a + b).long()
        dst = (dst << 1) | (((r > a) & (r <= a + b)) | (r > a + b + c)).long()
    key = torch.unique((src << 32) | dst)
    del src, dst
    keep = torch.randperm(key.shape[0], generator=gen, device=dev)
    key = key[keep[:LIVE_EDGES]].sort().values
    return ((key & 0xFFFFFFFF).int().contiguous(),
            (key >> 32).int().contiguous())


def kernel_inputs(dev, seed: int, e: int, n: int):
    """(wt, x) of each kernel, as described above, by kernel name."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    choice = torch.tensor([1.0, -1.0, 0.0, 2.0], device=dev)
    return {
        "gather_segsum": (
            choice[torch.randint(0, 4, (e,), generator=gen, device=dev)],
            torch.randint(-2, 3, (n,), generator=gen, device=dev).float()),
        "gather_segmin": (
            torch.rand((e,), generator=gen, device=dev),
            torch.rand((n,), generator=gen, device=dev) * 10.0)}


def nvcc_build(src: Path, tag: str, extra=()) -> ctypes.CDLL:
    """Build ``src`` with the port's nvcc flags plus ``extra`` into the
    build directory under its own library name, and load it."""
    from repro_torch.kernels import _build
    flags = (*_build.NVCC_FLAGS, *extra)
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = _build.BUILD_DIR / f"lib{tag}-{digest.hexdigest()[:16]}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not out.exists():
        proc = subprocess.run([_build._nvcc(), *flags, "-o", str(out),
                               str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                               f"{proc.stderr}")
        for line in (proc.stdout + proc.stderr).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas ({tag}): {line.strip()}")
    return ctypes.CDLL(str(out))


def parent_call(lib, name: str):
    """A call of an earlier build's ``<name>_launch(dst, seg_id, wt, x, y,
    n_edges, n_x, n_out, stream)``: y allocated here."""
    import torch
    from repro_torch.kernels import _build
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(dst, seg, wt, x, n):
        y = torch.empty((n,), dtype=torch.float32, device=x.device)
        rc = fn(dst.data_ptr(), seg.data_ptr(), wt.data_ptr(), x.data_ptr(),
                y.data_ptr(), dst.shape[0], x.shape[0], n,
                torch.cuda.current_stream().cuda_stream)
        _build.check(rc, name)
        return y
    return call


@contextlib.contextmanager
def library(lib):
    """The port's wrappers launch from ``lib`` inside the block."""
    from repro_torch.kernels import _build
    saved = _build._LIBS.get("segment_reduce")
    _build._LIBS["segment_reduce"] = lib
    _build._BOUND.pop("segment_reduce", None)
    try:
        yield
    finally:
        _build._LIBS["segment_reduce"] = saved
        _build._BOUND.pop("segment_reduce", None)


def check(name, got, want):
    import torch
    torch.cuda.synchronize()
    if name == "gather_segsum":
        ok = torch.allclose(got, want, rtol=cs.SEG_RTOL, atol=cs.SEG_ATOL)
    else:
        ok = torch.equal(cs._pos_zero(got), cs._pos_zero(want))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not ok:
        raise AssertionError(f"{name} differs from plain: max abs err {err}")
    return err, torch.equal(cs._pos_zero(got), cs._pos_zero(want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier segment_reduce.cu to time in turns")
    ap.add_argument("--o0", action="store_true",
                    help="also build the checkout's source at -Xptxas -O0")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("segment_bench: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_reduce as sr
    smi = cs.smi_line()
    print(f"card: {smi}")
    _build.build_all(["segment_reduce"])
    for line in _build.BUILD_LOG.get("segment_reduce", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas (checkout): {line.strip()}")
    dev = torch.device("cuda", 0)
    dst, seg = rmat_csr(dev, args.seed)
    e, n = dst.shape[0], 1 << cs.SCALE
    inputs = kernel_inputs(dev, args.seed, e, n)
    t_bound, by = cs.bound(12 * e + 8 * n, 2 * e)
    deg = torch.bincount(seg, minlength=n)
    print(f"csr: E={e} edges, n_out={n}, largest degree "
          f"{int(deg.max())}, empty segments {int((deg == 0).sum())}; "
          f"bound {t_bound:.4f} ms ({by})")
    parent = None
    if args.parent is not None:
        parent = nvcc_build(args.parent, "segment_reduce_parent")
    o0 = (nvcc_build(_build.CSRC / "segment_reduce.cu", "segment_reduce_o0",
                     ("-Xptxas", "-O0")) if args.o0 else None)
    for name, (wt, x) in inputs.items():
        kern = getattr(sr, f"{name}_cuda")
        want = getattr(sr, f"{name}_ref")(dst, seg, wt, x, n)
        err, exact = check(name, kern(dst, seg, wt, x, n), want)
        t = cs.segment_times(kern, dst, seg, wt, x, n)
        print(f"{name}: max abs err {err} (byte-equal {exact}); "
              f"{t['ms']:.4f} ms by events, {t['device_ms']:.4f} ms device "
              f"(reduction alone {t['reduce_ms']:.4f}); probes dst = 0 "
              f"{t['probe_zero_ms']:.4f}, dst = seg_id "
              f"{t['probe_seq_ms']:.4f}; {t_bound / t['ms']:.1%} of the "
              f"bound by events; kernels {t['device_kernels']} [{smi}]")
        if o0 is not None:
            with library(o0):
                err0, exact0 = check(name, kern(dst, seg, wt, x, n), want)
                ms0 = cs.time_ms(lambda: kern(dst, seg, wt, x, n))
            print(f"{name} at -Xptxas -O0: max abs err {err0} (byte-equal "
                  f"{exact0}); {ms0:.4f} ms by events [{smi}]")
        if parent is not None:
            old = parent_call(parent, name)
            check(name, old(dst, seg, wt, x, n), want)
            turns = []
            for who in ("parent", "new", "new", "parent"):
                fn = old if who == "parent" else kern
                turns.append((who, cs.time_ms(
                    lambda: fn(dst, seg, wt, x, n), iters=20)))
            pt = cs.segment_times(old, dst, seg, wt, x, n)
            print(f"{name} turns (ms by events): "
                  + ", ".join(f"{w} {ms:.4f}" for w, ms in turns)
                  + f"; parent {pt['device_ms']:.4f} ms device (reduction "
                  f"alone {pt['reduce_ms']:.4f}; probes dst = 0 "
                  f"{pt['probe_zero_ms']:.4f}, dst = seg_id "
                  f"{pt['probe_seq_ms']:.4f}) [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
