"""Run in a fresh interpreter by ``test_torch_dryrun.py``: reduced
configurations x train/prefill/decode on a (data 2, model 4) mesh over
the fake process group, then (``--graph``) the graph dry run at a small
size.  Prints one JSON object a line.

    PYTHONPATH=src python tests/_dryrun_cells.py OUT_DIR ARCH[,ARCH...] \
        [--graph]
"""
import json
import logging
import sys

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, graph_dryrun, shardings
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model

FAMILIES = ("qwen2-1.5b", "deepseek-v2-236b", "arctic-480b",
            "jamba-v0.1-52b", "whisper-small", "internvl2-26b")
SHAPES = (ShapeConfig("train_s", 32, 4, "train"),
          ShapeConfig("prefill_s", 32, 4, "prefill"),
          ShapeConfig("decode_s", 32, 4, "decode"))


def local_param_bytes(arch, mesh):
    """Each parameter's bytes over the product of the axes its spec
    splits it by (independent of ``distribute_params``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = reduced_config(arch)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    with FakeTensorMode():
        model = Model(cfg, device="cpu", seed=0)
    total = 0
    for name, spec in shardings.param_specs(cfg, mesh, model).items():
        p = dict(model.named_parameters())[name]
        div = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                div *= sizes.get(a, 1)
        total += p.numel() * p.element_size() // div
    return total


def main(out_dir, archs, graph):
    logging.disable(logging.WARNING)
    mesh = make_production_mesh(shape=(2, 4), axes=("data", "model"))
    for arch in archs:
        want_bytes = local_param_bytes(arch, mesh)
        for shape in SHAPES:
            rec = dryrun.run_cell(arch, shape, "small", "cpu",
                                  out_dir=out_dir, mesh=mesh,
                                  cfg_override=reduced_config(arch),
                                  micro4=False)
            rec.pop("traceback", None) if rec["status"] == "ok" else None
            rec["want_param_bytes"] = want_bytes
            print(json.dumps(rec, default=str), flush=True)
    if not graph:
        return
    rec = graph_dryrun.run("single", "cpu", v_per_shard=1 << 8,
                           e_per_shard=1 << 10, batch_cap=1 << 8,
                           bucket_cap=1 << 5, iters=3, out_dir=out_dir)
    print(json.dumps(rec, default=str), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2].split(","), "--graph" in sys.argv)


# --------------------------------------------------------------------------
# Helpers the dry-run test files share.
# --------------------------------------------------------------------------

def run_cells_in_subprocess(archs, graph=False, timeout=600):
    """Run ``main`` in a fresh interpreter; -> its records by (arch,
    shape)."""
    import os
    import subprocess
    import tempfile
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    with tempfile.TemporaryDirectory() as out:
        res = subprocess.run(
            [sys.executable, str(Path(__file__)), out, ",".join(archs)]
            + (["--graph"] if graph else []),
            capture_output=True, text=True, timeout=timeout,
            env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    recs = [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]
    return {(r["arch"], r["shape"]): r for r in recs}


def _storage_bytes(tensors):
    """The bytes of the distinct storages behind ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def plain_peak(fn):
    """The most bytes that ``fn()`` holds at once on the CPU above what
    was held when it started, from the profiler's allocation events: the
    step runs under no dispatch mode.  A block that an op allocates and
    frees before it returns (a CPU kernel's scratch: bf16 ``mm`` packs its
    weight on every call) is left out: a trace sees ops, not their
    insides, and on the card cuBLAS keeps its workspace across calls."""
    from torch.autograd.profiler import profile
    with profile(profile_memory=True) as prof:
        fn()
    evs = prof.kineto_results.events()
    ops = sorted((e.start_ns(), e.end_ns(), i) for i, e in enumerate(evs)
                 if e.name() != "[memory]")
    mem = sorted((e.start_ns(), e.nbytes()) for e in evs
                 if e.name() == "[memory]")
    # The innermost op open at each event (ops nest on one thread).
    owner, stack, j = [], [], 0
    for t, _ in mem:
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        owner.append(stack[-1][2] if stack else None)
    # Within one op, a free of n bytes after an allocation of n: scratch.
    open_, scratch = {}, set()
    for k, ((_, n), op) in enumerate(zip(mem, owner)):
        if op is None:
            continue
        if n > 0:
            open_.setdefault((op, n), []).append(k)
        elif open_.get((op, -n)):
            scratch.update((open_[(op, -n)].pop(), k))
    held = peak = 0
    for k, (_, n) in enumerate(mem):
        if k not in scratch:
            held += n
            peak = max(peak, held)
    return peak


def real_step(arch, shape, device="cpu"):
    """One real step of the reduced config on ``device``, as the dry run's
    ``card`` cell traces it, run twice: -> (the first run's peak with no
    dispatch mode, its inputs' bytes included; FlopCounterMode's total
    over the second)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import init_cache
    from repro_torch.optim import adamw_init
    cfg = reduced_config(arch)
    model = Model(cfg, device=device, seed=0)
    batch = dryrun.input_specs(cfg, shape, device)
    params = list(model.parameters())
    if shape.kind == "train":
        opt = adamw_init(model)
        step = dryrun.make_train_step(cfg, n_micro=1)
        ext = params + list(opt.m.values()) + list(opt.v.values()) + \
            list(batch.values()) + [opt.step]

        def run():
            return step(model, opt, batch)
    elif shape.kind == "prefill":
        step = dryrun.make_prefill_step(cfg, shape.seq_len + (
            dryrun.frontend_len(cfg, shape) if cfg.frontend == "vision"
            else 0))
        ext = params + list(batch.values())

        def run():
            return step(model, batch)
    else:
        cache = init_cache(cfg, shape.global_batch, shape.seq_len,
                           device=device)
        if cfg.family == "encdec":
            cache["cross"] = dryrun._cross_cache(
                cfg, shape.global_batch, dryrun.frontend_len(cfg, shape),
                device)
        ext = params + list(dryrun._tensors(cache)) + list(batch.values())
        step = dryrun.make_serve_step(cfg)

        def run():
            return step(model, cache, batch["token"], shape.seq_len - 1)
    peak = _storage_bytes(ext) + plain_peak(run)
    with FlopCounterMode(display=False) as fc:
        run()
    return peak, fc.get_total_flops()


def card_check(arch, shape):
    """The ``card`` cell's FLOPs and peak against a real CPU step."""
    stats, info = dryrun.trace_cell(arch, shape, None, "cpu",
                                    cfg_override=reduced_config(arch))
    peak, flops = real_step(arch, shape)
    assert stats.flops == flops, (arch, shape.kind, stats.flops, flops)
    assert abs(stats.peak - peak) <= dryrun.PEAK_TOL * peak, (
        arch, shape.kind, stats.peak, peak)
    assert info["replicated_at"] == []
    return stats, info


def check_mesh_records(recs, archs):
    """Every cell ``ok``, its per-device weights the local shards' sum, and
    the ``local`` points the families reach recorded."""
    for arch in archs:
        for shape in SHAPES:
            r = recs[(arch, shape.name)]
            assert r["status"] == "ok", (arch, shape.name, r.get("error"))
            assert r["chips"] == 8 and r["mesh"] == "small"
            assert r["param_bytes_per_device"] == r["want_param_bytes"]
            assert r["flops_per_device"] > 0 and r["peak_memory_per_device"] \
                > r["param_bytes_per_device"]
            assert r["scan_correction_flops"] == 0.0
            assert r["dtensor_patches"]["shape_probe"]
            assert "embed" in r["replicated_at"]
            if reduced_config(arch).moe is not None:
                assert "moe_dispatch" in r["replicated_at"]
            if shape.kind == "train":
                assert "target_logit" in r["replicated_at"]
                assert r["collective_bytes_per_device"] > 0
