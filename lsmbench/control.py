"""The control of each cell's comparison: the reference put in the
program's place and computed one precision lower (bfloat16 where the
configuration states float32 props and float32 analytics), judged by the
cell's own check at the cell's own size.  It has to come out as not
correct; its numbers are the upper readings the limits are set below.

    python3 lsmbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

if __name__ == "__main__":
    _here = Path(__file__).resolve().parent
    sys.path[:] = [str(_here.parent)] + [
        p for p in sys.path if Path(p or ".").resolve() != _here]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lsmbench import spec  # noqa: E402
from lsmbench.data import generator, make_stream  # noqa: E402
from lsmbench.ops.analytics import judge  # noqa: E402
from lsmbench.ops.common import Check, compare_lists, draw_vertices  # noqa
from lsmbench.reference import adjacency_of, lww_csr  # noqa: E402
from lsmbench.reference import algorithms as ref_alg  # noqa: E402

LOWER = torch.bfloat16


class _View:
    """A CSR in the shape ``judge`` reads from the program's view."""

    def __init__(self, voff, dst, prop) -> None:
        self.voff, self.dst, self.prop = voff, dst, prop


def _lists(stream, n, vs):
    """(got, want): the lower-precision reference's lists and the
    reference's, for vertices ``vs``."""
    s = stream
    want = lww_csr(s.src, s.dst, s.ins, s.prop, n)
    low = lww_csr(s.src, s.dst, s.ins, s.prop, n, prop_dtype=LOWER)
    low = (low[0], low[1], low[2].to(torch.float32))
    return adjacency_of(low, vs), adjacency_of(want, vs)


def control(cell: spec.Cell, seed: int, device) -> list:
    """The cell's compared numbers, with the control as the program."""
    cfg, w = cell.config, cell.workload
    n = int(cfg["store"]["config"]["vmax"])
    s = make_stream(cfg, seed, device)
    op = w["op"]
    if op == "ingest":
        g = generator(seed, "check", device)
        srcs = torch.unique(s.src)
        pick = srcs[torch.randperm(srcs.shape[0], generator=g,
                                   device=device)[:w["check"]["sources"]]]
        vs = torch.unique(pick).cpu().numpy().astype(np.int64)
        return compare_lists(*_lists(s, n, vs))
    if op == "read":
        pools = [draw_vertices(s.live_any, w["vertices"],
                               w["check"]["requests_per_client"], seed,
                               f"read{i}") for i in range(w["clients"])]
        vs = np.concatenate([v for pool in pools for v in pool])
        return compare_lists(*_lists(s, n, vs))
    if op == "analytics":
        voff, dst, prop = lww_csr(s.src, s.dst, s.ins, s.prop, n)
        pr_ref = ref_alg.pagerank(voff, dst, w["pagerank_iters"])
        key = int(s.live_in[0])
        view = _View(voff.to(torch.int32), dst,
                     prop.to(LOWER).to(torch.float32))
        pr = ref_alg.pagerank(voff, dst, w["pagerank_iters"], dtype=LOWER)
        hops = ref_alg.bfs_hops(voff, dst, key)
        dist = ref_alg.sssp(voff, dst, prop, key, dtype=LOWER)
        got = judge(view, pr, hops, dist.float(), key, voff, dst, prop,
                    pr_ref)
        return [Check(k, v, w["limits"].get(k, 0)) for k, v in got.items()]
    raise ValueError(f"no control for op {op!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        checks = control(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(c.ok for c in checks),
                          "checks": {c.name: {"value": c.value,
                                              "limit": c.limit}
                                     for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
