"""Dry run of the GRAPH side: the distributed LSMGraph service's
vertex-sharded PageRank sweeps and bucketed update router, traced on the
production meshes (the port of ``repro.launch.graph_dryrun``).

The graph layer runs one process a shard and joins them with a
``ShardMesh`` (``launch.mesh``).  Here one process plays rank 0 of the
``data`` axis (16 shards: the model axis holds replicas of each shard)
over torch's fake process group, on fake tensors, at the reference's sizes:
2^16 vertices and 2^20 edges a shard, 20 PageRank sweeps, a router batch
of 2^14 slots with buckets of 2^11.  Rank 0's program is traced with
``roofline.trace_step`` (FLOPs, bytes, peak).  Its collectives are the
``ShardMesh`` exchanges, which are not ``_c10d_functional`` ops: a counting
mesh records each one's operand bytes by the reference's kind names, and
``staged_bytes`` what a shard on a card stages through the host (input and
output of every collective).

    PYTHONPATH=src python -m repro_torch.launch.graph_dryrun [--mesh both] \\
        [--device cpu]

It writes ``experiments/dryrun_torch/<mesh>/lsmgraph-service__pagerank.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import numpy as np
import torch

from ..core.distributed import (ShardedCSR, make_distributed_pagerank,
                                make_route_updates)
from ..roofline.analysis import trace_step
from .dryrun import OUT_DIR
from .mesh import PRODUCTION_MESHES, ShardMesh, init_fake_group


class CountingMesh(ShardMesh):
    """A ``ShardMesh`` that counts its collectives: operand bytes by kind
    (``by_kind``) and, in ``staged_bytes``, the host copies a shard on a
    card makes (input plus output), whatever the device."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.by_kind = {}

    def _count(self, kind, fn, t, *args):
        self.by_kind[kind] = self.by_kind.get(kind, 0) + \
            t.numel() * t.element_size()
        return fn(t, *args)

    def _exchange(self, collective, out, inp):
        if inp.device.type == "cpu":
            self.staged_bytes += inp.numel() * inp.element_size() + \
                out.numel() * out.element_size()
        return super()._exchange(collective, out, inp)

    def all_gather(self, t, axis="data"):
        return self._count("all-gather", super().all_gather, t, axis)

    def all_reduce(self, t, op, axis="data"):
        return self._count("all-reduce", super().all_reduce, t, op, axis)

    def all_to_all(self, t, axis="data"):
        return self._count("all-to-all", super().all_to_all, t, axis)


def _shard_mesh(mesh_name: str, device) -> tuple:
    """A counting ``data`` mesh of the production mesh's data width over
    the fake group; -> (mesh, chips of the production mesh)."""
    shape, axes = PRODUCTION_MESHES[mesh_name]
    dp = shape[axes.index("data")]
    chips = int(np.prod(shape))
    init_fake_group(dp)
    return CountingMesh(("data",), (dp,), torch.device(device)), chips


def stand_in_csr(dp: int, v_per_shard: int, e_per_shard: int
                 ) -> ShardedCSR:
    """The stacked layout of ``dp`` shards as broadcast host arrays (no
    memory): every edge real (weight 1) from its shard's first vertex."""
    i32 = np.int32
    return ShardedCSR(
        dst=np.broadcast_to(np.zeros(1, i32), (dp, e_per_shard)),
        seg=np.broadcast_to((np.arange(dp, dtype=i32) * v_per_shard)
                            [:, None], (dp, e_per_shard)),
        wt=np.broadcast_to(np.ones(1, np.float32), (dp, e_per_shard)),
        deg=np.broadcast_to(np.ones(1, np.float32), (dp, v_per_shard)),
        v_start=np.arange(dp, dtype=i32) * v_per_shard,
        n_vertices=v_per_shard * dp, n_shards=dp)


def run(mesh_name: str, device, v_per_shard: int = 1 << 16,
        e_per_shard: int = 1 << 20, batch_cap: int = 1 << 14,
        bucket_cap: int = 1 << 11, iters: int = 20,
        out_dir: str = OUT_DIR) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    t0 = time.time()
    rec = {"arch": "lsmgraph-service", "mesh": mesh_name}
    try:
        mesh, chips = _shard_mesh(mesh_name, device)
        dp = mesh.shape[0]
        V = v_per_shard * dp
        rec.update(shape=f"V{V}_E{e_per_shard * dp}", chips=chips)
        shard = stand_in_csr(dp, v_per_shard, e_per_shard)
        with FakeTensorMode(allow_non_fake_inputs=True):
            pr = make_distributed_pagerank(mesh, shard, iters=iters)
            # The run's own shard is made before the trace; a second
            # placement of it, of the same sizes, stands for it as the
            # external memory.
            local = shard.local(0, mesh.device)
            _, stats = trace_step(pr, external=list(local[:5]),
                                  device=mesh.device)
        coll = dict(mesh.by_kind)
        rec.update({
            "status": "ok",
            "flops_per_device": stats.flops,
            "bytes_per_device": stats.bytes,
            "coll_breakdown": coll,
            "collective_bytes_per_device": float(sum(coll.values())),
            "staged_bytes_per_device": float(mesh.staged_bytes),
            "peak_memory_per_device": stats.peak,
        })
        # The router: one batch of batch_cap slots a rank.  Its bucket
        # layout has data-dependent sizes, so it runs with symbolic shapes
        # and only its exchange is counted.
        mesh.by_kind, staged = {}, mesh.staged_bytes
        router = make_route_updates(mesh, v_local=v_per_shard, n_shards=dp,
                                    batch_cap=batch_cap,
                                    bucket_cap=bucket_cap)
        with FakeTensorMode(shape_env=ShapeEnv()):
            z = torch.zeros(batch_cap, dtype=torch.int32,
                            device=mesh.device)
            router(z, z, z.float(), batch_cap)
        rec["router_coll_breakdown"] = dict(mesh.by_kind)
        rec["router_staged_bytes"] = float(mesh.staged_bytes - staged)
        rec["trace_s"] = round(time.time() - t0, 1)
        print(f"[graph-dryrun] {mesh_name}: OK chips={chips} "
              f"pr_coll={rec['collective_bytes_per_device'] / 1e6:.1f}MB/dev"
              f" router_coll="
              f"{sum(rec['router_coll_breakdown'].values()) / 1e6:.1f}"
              f"MB/dev", flush=True)
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[graph-dryrun] {mesh_name}: FAILED {e}", flush=True)
    rec["wall_s"] = round(time.time() - t0, 1)
    d = os.path.join(out_dir, mesh_name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "lsmgraph-service__pagerank.json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multipod", "both"])
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="the device the fake tensors claim (default: the "
                         "current CUDA card)")
    args = ap.parse_args(argv)
    from ..core.types import resolve_device
    device = resolve_device(args.device)
    meshes = (["single", "multipod"] if args.mesh == "both" else [args.mesh])
    recs = [run(m, device, out_dir=args.out) for m in meshes]
    return 1 if any(r["status"] != "ok" for r in recs) else 0


if __name__ == "__main__":
    raise SystemExit(main())
