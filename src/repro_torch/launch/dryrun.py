"""Dry run: trace EVERY (arch x shape x mesh) cell on fake tensors (the
port of ``repro.launch.dryrun``).

For each cell it shows that the distribution config is coherent (the
shardings compose, the collectives are legal, the step fits on a card)
and harvests the roofline terms.  The reference lowers and compiles the
step with XLA on 512 placeholder devices; here one process plays rank 0 of
the production mesh over torch's fake process group
(``launch.mesh.make_production_mesh``), the weights, optimizer state,
batch and cache are DTensors of fake tensors laid out by
``launch.shardings``, and the step runs once under ``FakeTensorMode`` with
``roofline.trace_step`` reading each op of one device's program (FLOPs,
bytes, collectives, and the peak from ``MemTracker``).  No data exists and
no card is needed.

The mesh ``card`` is one H100 and no mesh at all: a plain trace of the step
as it runs on one card, which ``chip_smoke.py`` phase 14 holds against a
real step.

Results go to ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``, one
file a cell, so a sweep can resume (``--skip-done``).  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh single --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --device cpu

``--device`` is the device the fake tensors claim (default: the current
CUDA card, which fake CUDA tensors need a CUDA build of torch for; the
tests and a CPU-only host pass ``cpu``).

The reference adds a scan-body correction (``probe_cell_correction``):
XLA's cost analysis counts a scanned layer once.  The port runs its
layers in a Python loop, so every layer is traced and counted;
``scan_correction_flops`` is 0.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch

from ..configs import ARCH_IDS, get_config, get_shape, shape_applicable
from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..models import model as modellib
from ..models import partition
from ..optim.adamw import adamw_init
from ..roofline.analysis import (HW, analyze_trace, patch_dtensor_tracing,
                                 trace_step)
from . import shardings as shl
from . import train as trainlib
from .mesh import PRODUCTION_MESHES, make_production_mesh, mesh_size

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
MESH_NAMES = tuple(PRODUCTION_MESHES)
#: The most a ``card`` cell's traced peak may differ from the measured peak
#: of the same step run with no dispatch mode, relative to the measured one
#: (``chip_smoke.py`` phase 14 and the tests hold the trace to it).
PEAK_TOL = 0.10


# --------------------------------------------------------------------------
# input_specs: fake stand-ins for every model input.
# --------------------------------------------------------------------------

def frontend_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.frontend == "vision":
        return 256                      # ViT patch embeddings (stub)
    if cfg.frontend == "audio":
        return max(shape.seq_len // 2, 128)  # conv-downsampled frames (stub)
    return 0


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device) -> Dict[str, torch.Tensor]:
    """A cell's batch as zero tensors of its shapes and dtypes; under
    ``FakeTensorMode`` they hold no data."""
    b, s = shape.global_batch, shape.seq_len

    def zeros(shp, dtype):
        return torch.zeros(shp, dtype=dtype, device=device)
    if shape.kind == "decode":
        # One new token against a seq_len-deep cache.
        return {"token": zeros((b,), torch.int32)}
    batch = {"tokens": zeros((b, s), torch.int32)}
    if shape.kind == "train":
        batch["targets"] = zeros((b, s), torch.int32)
    fl = frontend_len(cfg, shape)
    if fl:
        batch["frontend"] = zeros((b, fl, cfg.d_model), torch.bfloat16)
    return batch


# --------------------------------------------------------------------------
# Step builders
# --------------------------------------------------------------------------

#: The port's training step (``launch.train``): the loss and gradients over
#: ``n_micro`` micro-batches, the cosine schedule, one AdamW update.
make_train_step = trainlib.make_train_step


def make_prefill_step(cfg: ModelConfig, s_max: int):
    def prefill_step(model, batch):
        logits, cache = modellib.prefill(cfg, model, batch, s_max=s_max)
        # The output's layout is stated, as the reference's out_shardings.
        return partition.constrain(logits, "dp", None), cache
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    def serve_step(model, cache, token, pos):
        return modellib.decode_step(cfg, model, cache, token, pos)
    return serve_step


# --------------------------------------------------------------------------
# Cell tracing
# --------------------------------------------------------------------------

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _local_bytes(t) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _cross_cache(cfg: ModelConfig, b: int, enc_len: int, device):
    """An encdec decoder's cross-attention k/v, one pair a layer (the
    reference's ``init_cache(enc_len=...)``)."""
    shp = (b, enc_len, cfg.n_heads, cfg.hd)
    return [{k: partition.cache_zeros(k, shp, torch.bfloat16, device)
             for k in ("k", "v")} for _ in range(cfg.n_layers)]


def trace_cell(arch: str, shape: Union[str, ShapeConfig], mesh,
               device, n_micro: int = 1,
               cfg_override: Optional[ModelConfig] = None,
               s_max: Optional[int] = None):
    """Trace one cell's step on fake tensors.  -> ``(TraceStats, info)``,
    or ``(None, reason)`` when the cell does not apply.  ``mesh`` is a
    ``DeviceMesh`` or ``None`` (one card); ``info`` holds the
    ``replicated_at`` points and the per-device parameter bytes.  A
    prefill's cache is ``s_max`` deep (default: the prompt, and a vision
    prefix)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, why
    device = torch.device(device)
    patched = patch_dtensor_tracing()
    if mesh is not None and not patched["shape_probe"]:
        raise RuntimeError(
            "this torch release's DTensor has no sharding-propagation method "
            "that patch_dtensor_tracing knows: its shape probes on global "
            "fake tensors would count as device work")
    with FakeTensorMode():
        model = modellib.Model(cfg, device=device, seed=0)
        if mesh is not None:
            shl.distribute_params(cfg, mesh, model)
        params = list(model.parameters())
        batch = input_specs(cfg, shape, device)
        if mesh is not None:
            batch = shl.distribute_batch(mesh, batch)
        with partition.shard_context(mesh):
            if shape.kind == "train":
                opt = adamw_init(model)
                step = make_train_step(cfg, n_micro=n_micro)
                ext = params + list(_tensors(opt.m)) + \
                    list(_tensors(opt.v)) + list(_tensors(batch)) + \
                    [opt.step]

                def run():
                    return step(model, opt, batch)
            elif shape.kind == "prefill":
                if s_max is None:
                    s_max = shape.seq_len + (
                        frontend_len(cfg, shape)
                        if cfg.frontend == "vision" else 0)
                step = make_prefill_step(cfg, s_max)
                ext = params + list(_tensors(batch))

                def run():
                    return step(model, batch)
            else:
                cache = modellib.init_cache(cfg, shape.global_batch,
                                            shape.seq_len, device=device)
                if cfg.family == "encdec":
                    cache["cross"] = _cross_cache(
                        cfg, shape.global_batch,
                        max(frontend_len(cfg, shape), 1), device)
                step = make_serve_step(cfg)
                ext = params + list(_tensors(cache)) + list(_tensors(batch))

                def run():
                    return step(model, cache, batch["token"],
                                shape.seq_len - 1)
            _, stats = trace_step(run, external=ext, device=device)
            points = list(partition.replicated_at())
    info = {"replicated_at": points,
            "dtensor_patches": dict(patched),
            "param_bytes_per_device": float(sum(_local_bytes(p)
                                                for p in params))}
    return stats, info


def _mesh_for(mesh_name: str, device):
    if mesh_name == "card":
        return None
    return make_production_mesh(multi_pod=(mesh_name == "multipod"),
                                device_type=torch.device(device).type)


def run_cell(arch: str, shape_name: Union[str, ShapeConfig],
             mesh_name: str, device, out_dir: str = OUT_DIR, mesh=None,
             cfg_override: Optional[ModelConfig] = None,
             micro4: bool = True) -> Dict[str, Any]:
    """Trace one cell, write its record and return it.  Status ``ok``,
    ``skipped`` (with the reason) or ``failed`` (with the traceback).
    ``mesh`` overrides the production mesh of ``mesh_name``; a
    ``ShapeConfig`` may stand for a shape's name.  A train cell is traced
    again with 4 micro-batches for its peak unless ``micro4`` is off."""
    shape = (get_shape(shape_name) if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name}
    try:
        if mesh is None:
            mesh = _mesh_for(mesh_name, device)
        chips = 1 if mesh is None else mesh_size(mesh)
        rec["chips"] = chips
        stats, info = trace_cell(arch, shape, mesh, device,
                                 cfg_override=cfg_override)
        if stats is None:
            rec["status"] = "skipped"
            rec["reason"] = info
            _write(rec, out_dir)
            return rec
        cfg = cfg_override if cfg_override is not None else get_config(arch)
        sizes = ({} if mesh is None else
                 dict(zip(partition.axis_names(mesh), mesh.shape)))
        report = analyze_trace(stats, arch=arch, shape_cfg=shape, cfg=cfg,
                               mesh_name=mesh_name, chips=chips,
                               hw=HW.for_mesh(sizes))
        rec.update(report.to_json())
        rec.update(info)
        rec["peak_breakdown"] = stats.peak_breakdown
        rec["link_bw"] = report.hw.link_bw
        rec["scan_correction_flops"] = 0.0
        rec["scan_correction_bytes"] = 0.0
        rec["status"] = "ok"
        rec["trace_s"] = round(time.time() - t0, 1)
        if shape.kind == "train" and micro4:
            # Production fit check: 4 micro-batches divide the activation
            # peak; the roofline terms stay on the n_micro=1 trace.
            try:
                s4, _ = trace_cell(arch, shape, mesh, device, n_micro=4,
                                   cfg_override=cfg_override)
                rec["peak_memory_per_device_micro4"] = s4.peak
            except Exception as pe:  # recorded, not dropped
                rec["micro4_error"] = f"{type(pe).__name__}: {pe}"
        rec["wall_s"] = round(time.time() - t0, 1)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"({rec['wall_s']:.0f} s, bottleneck={rec['bottleneck']}, "
              f"peak/dev={rec['peak_memory_per_device'] / 1e9:.2f} GB"
              + (f", micro4={rec['peak_memory_per_device_micro4'] / 1e9:.2f}"
                 " GB" if "peak_memory_per_device_micro4" in rec else "")
              + ")", flush=True)
    except Exception as e:  # a failure here is a bug in the system
        rec["status"] = "failed"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        rec["wall_s"] = round(time.time() - t0, 1)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAILED {e}",
              flush=True)
    _write(rec, out_dir)
    return rec


def _write(rec: Dict[str, Any], out_dir: str) -> None:
    d = os.path.join(out_dir, rec["mesh"])
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=list(MESH_NAMES) + ["both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--no-micro4", action="store_true",
                    help="skip a train cell's second trace with 4 "
                         "micro-batches")
    ap.add_argument("--device", default=None,
                    help="the device the fake tensors claim (default: the "
                         "current CUDA card)")
    args = ap.parse_args(argv)
    from ..core.types import resolve_device
    device = resolve_device(args.device)

    meshes = (["single", "multipod"] if args.mesh == "both"
              else [args.mesh])
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = ([s.name for s in SHAPES] if (args.all or args.shape is None)
              else [args.shape])
    failed = 0
    for mesh_name in meshes:
        mesh = _mesh_for(mesh_name, device)
        for arch in archs:
            for shape_name in shapes:
                if args.skip_done:
                    p = os.path.join(args.out, mesh_name,
                                     f"{arch}__{shape_name}.json")
                    if os.path.exists(p):
                        with open(p) as f:
                            if json.load(f).get("status") in ("ok",
                                                              "skipped"):
                                continue
                rec = run_cell(arch, shape_name, mesh_name, device,
                               out_dir=args.out, mesh=mesh,
                               micro4=not args.no_micro4)
                failed += rec["status"] == "failed"
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
