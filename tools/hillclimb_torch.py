"""Hillclimbs of the three designated dry-run cells, traced by the port.

    PYTHONPATH=src python tools/hillclimb_torch.py --cell A|B|C|all \
        [--variant name] [--device cpu] [--out DIR]

A is deepseek-v2-236b x prefill_32k, B jamba-v0.1-52b x train_4k (both on
the single-pod mesh, through ``repro_torch.launch.dryrun.trace_cell``), C
the distributed PageRank of the graph service with each iterate exchange
(``fp32``, ``bf16``, ``int8``).  Each variant's three roofline terms and
peak go to ``experiments/hillclimb_torch/<cell>__<variant>.json``.  The
variants are the reference's config knobs; its A4 (the prefill cache's
output layout) and A6 (a scanned chunk loop) are how the port always runs
and trace as A1 does.
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import graph_dryrun as gdr  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     mesh_size)
from repro_torch.models import partition  # noqa: E402
from repro_torch.roofline.analysis import HW, analyze_trace  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
OUT = os.path.join(ROOT, "experiments", "hillclimb_torch")


def _write(rec, name, out):
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def run_lm_variant(arch, shape_name, variant, cfg, n_micro, device, out):
    import torch
    mesh = make_production_mesh(device_type=torch.device(device).type)
    t0 = time.time()
    rec = {"cell": f"{arch}__{shape_name}", "variant": variant,
           "n_micro": n_micro}
    try:
        stats, info = dr.trace_cell(arch, shape_name, mesh, device,
                                    n_micro=n_micro, cfg_override=cfg)
        rep = analyze_trace(
            stats, arch=arch, shape_cfg=get_shape(shape_name), cfg=cfg,
            mesh_name="single", chips=mesh_size(mesh),
            hw=HW.for_mesh(dict(zip(partition.axis_names(mesh),
                                    mesh.shape))))
        rec.update(rep.to_json())
        rec.update(info)
        rec["status"] = "ok"
        rec["trace_s"] = round(time.time() - t0, 1)
        print(f"[hc] {arch}/{shape_name} {variant}: peak="
              f"{rec['peak_memory_per_device']/1e9:.1f}GB "
              f"tm={rec['t_memory_s']:.2f}s tc={rec['t_compute_s']:.2f}s "
              f"tl={rec['t_collective_s']:.2f}s frac="
              f"{rec['roofline_fraction']*100:.1f}%", flush=True)
    except Exception as e:  # recorded, not dropped
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2500:]
        print(f"[hc] {arch}/{shape_name} {variant}: FAILED {e}", flush=True)
    _write(rec, f"{arch}__{shape_name}__{variant}", out)
    return rec


def cell_a(variant, device, out):
    """deepseek-v2-236b x prefill_32k."""
    arch, shape = "deepseek-v2-236b", "prefill_32k"
    base = get_config(arch)
    chunked = dataclasses.replace(base, mla_absorbed_prefill=True)
    variants = {
        "a0_base": (base, 1),
        # A1: latent-chunked K/V expansion, (B,S,H,.) never materialised.
        "a1_latent_chunked": (chunked, 1),
        # A2: head-split MLA q/k/v (the constrain calls, always on).
        "a2_headshard": (base, 1),
        # A3: A1 + a tighter MoE capacity.
        "a3_headshard_chunked_cap1": (
            dataclasses.replace(chunked, moe_capacity_override=1.0), 1),
        "a4_cache_outsharding": (chunked, 1),
        "a6_scan_chunks": (chunked, 1),
    }
    return [run_lm_variant(arch, shape, name, cfg, nm, device, out)
            for name, (cfg, nm) in variants.items()
            if not variant or variant == name]


def cell_b(variant, device, out):
    """jamba-v0.1-52b x train_4k."""
    arch, shape = "jamba-v0.1-52b", "train_4k"
    base = get_config(arch)
    variants = {
        "b0_base": (base, 1),
        "b1_micro4": (base, 4),
        "b2_micro8": (base, 8),
        "b3_micro8_dots": (dataclasses.replace(base, remat_policy="dots"),
                           8),
        "b4_micro8_cap1": (
            dataclasses.replace(base, moe_capacity_override=1.0), 8),
    }
    return [run_lm_variant(arch, shape, name, cfg, nm, device, out)
            for name, (cfg, nm) in variants.items()
            if not variant or variant == name]


def cell_c(variant, device, out):
    """The graph service's PageRank with each iterate exchange."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.distributed import make_distributed_pagerank
    recs = []
    for ex in ("fp32", "bf16", "int8"):
        if variant and variant != ex:
            continue
        t0 = time.time()
        mesh, chips = gdr._shard_mesh("single", device)
        shard = gdr.stand_in_csr(mesh.shape[0], 1 << 16, 1 << 20)
        with FakeTensorMode(allow_non_fake_inputs=True):
            make_distributed_pagerank(mesh, shard, iters=20, exchange=ex)()
        coll = dict(mesh.by_kind)
        rec = {"cell": "lsmgraph-service__pagerank", "variant": f"c_{ex}",
               "status": "ok", "chips": chips, "coll_breakdown": coll,
               "collective_bytes_per_device": float(sum(coll.values())),
               "t_collective_s": float(sum(coll.values())) / HW().link_bw,
               "trace_s": round(time.time() - t0, 1)}
        _write(rec, f"lsmgraph-service__pagerank__c_{ex}", out)
        print(f"[hc] graph-pr {ex}: coll/dev="
              f"{rec['collective_bytes_per_device']/1e6:.1f}MB "
              f"t_coll={rec['t_collective_s']*1e3:.3f}ms", flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="all", choices=["A", "B", "C", "all"])
    ap.add_argument("--variant", default=None)
    ap.add_argument("--device", default=None,
                    help="the device the fake tensors claim (default: the "
                         "current CUDA card)")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    from repro_torch.core.types import resolve_device
    device = resolve_device(args.device)
    recs = []
    if args.cell in ("A", "all"):
        recs += cell_a(args.variant, device, args.out)
    if args.cell in ("B", "all"):
        recs += cell_b(args.variant, device, args.out)
    if args.cell in ("C", "all"):
        recs += cell_c(args.variant, device, args.out)
    return 1 if any(r["status"] != "ok" for r in recs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
