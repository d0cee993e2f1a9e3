#!/usr/bin/env python3
"""Time variants of the single-run segment kernels in turns on one NVIDIA
GPU, to show what their time depends on.

    python3 tools/segment_variants.py --parent OLD/segment_reduce.cu

Each variant is a text edit of an earlier ``segment_reduce.cu`` (the
parent) or of the checkout's, built under its own library name with the
port's nvcc flags, held against the plain version on
``tools/segment_bench.py``'s R-MAT scale-22 CSR, and timed by CUDA events
in two rounds (the variants in order, then in reverse), with the dst = 0
probe by ``torch.profiler``:

- ``parent``; ``parent+smem8k`` and ``parent+smem24k``: the parent with
  8,512 or 24,000 bytes of shared memory a CTA that it never reads, which
  the L1 cache then lacks;
- ``parent+ballot``: the parent with the checkout's ballot-led scan only;
- ``checkout``; ``checkout@256``: CTAs of 256 threads, not 512;
- ``checkout+noalloc`` / ``+evictfirst`` / ``+ca``: dst, seg_id and wt
  read with ``ld.global.nc.L1::no_allocate`` / ``L1::evict_first``, or x
  gathered with ``ld.global.ca``;
- ``checkout+x_evictlast``: x gathered with ``L1::evict_last``;
- ``checkout+l2_256B``: the streams read no-allocate with a 256-byte L2
  prefetch.

Fails without a card.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import segment_bench as sb  # noqa: E402

PTX = {
    "noalloc": "ld.global.nc.L1::no_allocate",
    "evictfirst": "ld.global.nc.L1::evict_first",
    "l2_256B": "ld.global.nc.L1::no_allocate.L2::256B",
}
PARENT_SCAN = """#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vo = __shfl_down_sync(kFull, v, off);
      const int so = __shfl_down_sync(kFull, s, off);
      if (lane + off < 32 && so == s) v = Op::combine(v, vo);
    }
    const int s_prev = __shfl_up_sync(kFull, s, 1);
    const bool head = lane == 0 || s_prev != s;
"""
BALLOT_SCAN = """    const int s_prev = __shfl_up_sync(kFull, s, 1);
    const bool head = lane == 0 || s_prev != s;
    const unsigned heads = __ballot_sync(kFull, head);
    const unsigned after = lane < 31 ? heads >> (lane + 1) : 0u;
    const int seg_end = after ? lane + __ffs(after) - 1 : 31;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float vo = __shfl_down_sync(kFull, v, off);
      if (lane + off <= seg_end) v = Op::combine(v, vo);
    }
"""
PARENT_BALLOT = ("    const unsigned heads = __ballot_sync(kFull, head);\n"
                 "    const int last_head")
STREAMS = ("s = max(__ldcs(seg_id + i), 0);", "__ldcs(dst + i)",
           "__ldcs(wt + i)")


def edit(src: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` replaced; fails if there is none."""
    if old not in src:
        raise ValueError(f"variant anchor not found: {old[:60]!r}")
    return src.replace(old, new, 1)


def with_loads(src: str, ptx: str, gather: bool = False) -> str:
    """The checkout's kernel with its stream loads (or its gather of x)
    made the given PTX load, through two helpers put in its namespace."""
    helpers = "".join(
        f'__device__ __forceinline__ {t} ld_v(const {t}* p) {{ {t} r; '
        f'asm("{ptx}.{s} %0, [%1];" : "={c}"(r) : "l"(p)); return r; }}\n'
        for t, s, c in (("int", "s32", "r"), ("float", "f32", "f")))
    src = edit(src, "namespace {\n", "namespace {\n" + helpers)
    if gather:
        return edit(src, "__ldg(x + d));\n      }",
                    "ld_v(x + d));\n      }")
    for old in STREAMS:
        src = edit(src, old, old.replace("__ldcs", "ld_v"))
    return src


def variants(parent: str, checkout: str):
    def smem(words: int) -> str:
        return edit(parent, "const int lane = threadIdx.x & 31;",
                    f"__shared__ volatile float pad[{words}];\n"
                    "  pad[threadIdx.x] = 0.0f;\n"
                    "  const int lane = threadIdx.x & 31;")
    ballot = edit(edit(parent, PARENT_SCAN, BALLOT_SCAN), PARENT_BALLOT,
                  "    const int last_head")
    return {
        "parent": parent,
        "parent+smem8k": smem(2128),
        "parent+smem24k": smem(6000),
        "parent+ballot": ballot,
        "checkout": checkout,
        "checkout@256": edit(checkout, "constexpr int kSingleThreads = 512;",
                             "constexpr int kSingleThreads = 256;"),
        "checkout+noalloc": with_loads(checkout, PTX["noalloc"]),
        "checkout+evictfirst": with_loads(checkout, PTX["evictfirst"]),
        "checkout+ca": edit(checkout, "__ldg(x + d));\n      }",
                            "__ldca(x + d));\n      }"),
        "checkout+x_evictlast": with_loads(
            checkout, "ld.global.nc.L1::evict_last", gather=True),
        "checkout+l2_256B": with_loads(checkout, PTX["l2_256B"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="an earlier segment_reduce.cu with the same C "
                         "interface")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "variants",
                    help="where the variant sources are written")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("segment_variants: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import segment_reduce as sr
    smi = cs.smi_line()
    print(f"card: {smi}")
    srcs = variants(args.parent.read_text(),
                    (_build.CSRC / "segment_reduce.cu").read_text())
    args.out.mkdir(parents=True, exist_ok=True)
    calls = {}
    for name, text in srcs.items():
        path = args.out / f"{name.replace('+', '_')}.cu"
        path.write_text(text)
        calls[name] = sb.nvcc_build(path, "segvar_" + path.stem)
    dev = torch.device("cuda", 0)
    dst, seg = sb.rmat_csr(dev, args.seed)
    e, n = dst.shape[0], 1 << cs.SCALE
    zero = torch.zeros_like(dst)
    for kname, (wt, x) in sb.kernel_inputs(dev, args.seed, e, n).items():
        want = getattr(sr, f"{kname}_ref")(dst, seg, wt, x, n)
        fns = {v: sb.parent_call(lib, kname) for v, lib in calls.items()}
        times = {v: [] for v in fns}
        for v in list(fns) + list(fns)[::-1]:
            fn = fns[v]
            sb.check(kname, fn(dst, seg, wt, x, n), want)
            times[v].append(cs.time_ms(lambda: fn(dst, seg, wt, x, n),
                                       iters=20))
        for v, ms in times.items():
            fn = fns[v]
            probe = cs.device_ms(lambda: fn(zero, seg, wt, x, n),
                                 cs.SEG_REDUCE_KERNEL)
            print(f"{kname} {v}: {ms[0]:.4f} and {ms[1]:.4f} ms by events; "
                  f"dst = 0 probe {probe:.4f} ms device [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
