"""Render the dry-run and roofline tables from the dry-run JSON records
(the port of ``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report \\
        [--dir experiments/dryrun_torch] [--mesh single]

The records are ``launch.dryrun``'s and ``launch.graph_dryrun``'s, one
directory a mesh (``single``, ``multipod``, ``card``).  The service
record's collective term is over the cross-node link of
``roofline.analysis.IB_BW``.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

from ..configs import ARCH_IDS
from ..configs.base import SHAPES
from .analysis import IB_BW

MESHES = ("single", "multipod", "card")


def load_records(base: str) -> List[Dict]:
    recs = []
    for mesh in MESHES:
        d = os.path.join(base, mesh)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    recs.append(json.load(f))
    return recs


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    x = float(x)
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def next_lever(r: Dict) -> str:
    """One sentence per cell: what would move the dominant term down."""
    shape, bound = r.get("shape", ""), r.get("bottleneck", "")
    arch = r.get("arch", "")
    moe = arch in ("arctic-480b", "deepseek-v2-236b", "jamba-v0.1-52b")
    if bound == "collective":
        return ("compress/overlap the dominant reduce-scatter or all-reduce "
                "(int8+EF) or re-balance TP vs DP degrees")
    if bound == "memory":
        return ("fuse the eager step's elementwise chains (the bytes term "
                "counts every intermediate written and read back)")
    if shape.startswith("train"):
        if moe:
            return ("micro-batching; MoE dispatch bytes scale with "
                    "capacity")
        return ("micro-batching divides activation traffic; then remat "
                "policy to trade recompute for reads")
    if shape.startswith("prefill"):
        return "chunk the prompt so per-layer transients stay one chunk"
    if shape.startswith("decode") or shape.startswith("long"):
        return ("decode is cache-read-bound: quantize the KV/latent cache "
                "(int8) or batch more requests per sweep")
    return "-"


def roofline_table(recs: List[Dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | t_comp | t_mem | t_coll | bound | "
            "peak/dev | MODEL/traced | frac | wall | next lever |",
            "|---|---|---|---|---|---|---|---|---|---|---|"]
    order = {a: i for i, a in enumerate(ARCH_IDS)}
    shp = {s.name: i for i, s in enumerate(SHAPES)}
    recs = [r for r in recs if r.get("mesh") == mesh]
    recs.sort(key=lambda r: (order.get(r["arch"], 99),
                             shp.get(r["shape"], 9)))
    for r in recs:
        wall = _fmt_s(r.get("wall_s"))
        if r.get("status") == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skipped | — | — | — | {wall} | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"FAILED | — | — | — | {wall} | — |")
            continue
        if "t_compute_s" not in r:  # service record (different schema)
            coll = r.get("collective_bytes_per_device", 0)
            rows.append(
                f"| {r['arch']} | {r['shape']} | — | — | "
                f"{_fmt_s(coll / IB_BW)}/run | — | "
                f"{r.get('peak_memory_per_device', 0)/1e9:.2f}GB | — | — | "
                f"{wall} | int8 iterate exchange |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(r['t_compute_s'])} | "
            f"{_fmt_s(r['t_memory_s'])} | {_fmt_s(r['t_collective_s'])} | "
            f"{r['bottleneck']} | {r['peak_memory_per_device']/1e9:.1f}GB | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']*100:.1f}% | {wall} | "
            f"{next_lever(r)} |")
    return "\n".join(rows)


_BOUND = {"compute": "C", "memory": "M", "collective": "L"}


def sweep_matrix(recs: List[Dict], meshes=MESHES) -> str:
    """The whole sweep on one screen: a row an architecture, a column a
    shape; each cell gives, for each mesh in ``meshes`` order, the
    bottleneck (C compute, M memory, L collective; ``skip``, ``FAIL``)
    and the cell's wall seconds, e.g. ``L 131 / L 140 / M 53``."""
    by = {(r.get("arch"), r.get("shape"), r.get("mesh")): r for r in recs}

    def one(r):
        if r is None:
            return "-"
        if r.get("status") == "skipped":
            return "skip"
        if r.get("status") != "ok":
            return "FAIL"
        return f"{_BOUND.get(r.get('bottleneck'), '?')} {r['wall_s']:.0f}"
    rows = ["| arch | " + " | ".join(s.name for s in SHAPES) + " |",
            "|---|" + "---|" * len(SHAPES)]
    for arch in ARCH_IDS:
        cells = [" / ".join(one(by.get((arch, s.name, m))) for m in meshes)
                 for s in SHAPES]
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def dryrun_summary(recs: List[Dict]) -> str:
    out = []
    for mesh in MESHES:
        sub = [r for r in recs if r.get("mesh") == mesh]
        if not sub:
            continue
        ok = sum(1 for r in sub if r.get("status") == "ok")
        skip = sum(1 for r in sub if r.get("status") == "skipped")
        fail = sum(1 for r in sub if r.get("status") == "failed")
        out.append(f"- **{mesh}**: {ok} ok / {skip} skipped (documented) / "
                   f"{fail} failed of {len(sub)} recorded cells")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "experiments",
        "dryrun_torch"))
    ap.add_argument("--mesh", default="single", choices=list(MESHES))
    ap.add_argument("--matrix", action="store_true",
                    help="print the sweep matrix of every mesh instead "
                         "of one mesh's table")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(dryrun_summary(recs))
    print()
    print(sweep_matrix(recs) if args.matrix
          else roofline_table(recs, args.mesh))


if __name__ == "__main__":
    main()
