"""The port's roofline layer against the JAX package's.

* ``model_flops`` equals the reference's for every architecture x shape.
* ``RooflineReport``: the same properties and ``to_json`` keys and values
  as the reference's for the same numbers and the same card constants.
* ``collective_bytes_from_trace`` on collectives built by hand over the fake
  process group (in a fresh interpreter: a process holds one default group)
  equals their operand bytes counted by hand, by the reference's kind names.
* ``TraceCounter`` counts a DTensor product's local share, not the global
  product, and skips DTensor's shape probes.
* ``report.py`` renders its summary and tables from records.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import SHAPES as REF_SHAPES  # noqa: E402
from repro.roofline import analysis as ref_an  # noqa: E402
from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.roofline import analysis as an  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_reference(arch):
    for s in REF_SHAPES:
        assert an.model_flops(get_config(arch), get_shape(s.name)) == \
            ref_an.model_flops(ref_get_config(arch), s), (arch, s.name)


@pytest.mark.parametrize("numbers", [
    (2.1e15, 3.3e12, 4.0e10, {"all-gather": 3e10, "all-reduce": 1e10},
     5.5e10, 4.4e17, 256),
    (1e9, 8e12, 0.0, {}, 1e9, 1e12, 1),        # no collectives
    (0.0, 0.0, 0.0, {}, 0.0, 0.0, 512),        # an empty trace
])
def test_report_equals_reference(numbers):
    flops, byt, coll, br, peak, mflops, chips = numbers
    hw = an.HW()
    ref_hw = ref_an.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                       link_bw=hw.link_bw, hbm_bytes=hw.hbm_bytes)
    kw = dict(arch="a", shape="s", mesh="single", chips=chips,
              flops_per_device=flops, bytes_per_device=byt,
              collective_bytes_per_device=coll, coll_breakdown=br,
              peak_memory_per_device=peak, model_flops=mflops)
    got = an.RooflineReport(hw=hw, **kw)
    want = ref_an.RooflineReport(hw=ref_hw, **kw)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "roofline_fraction", "useful_flops_ratio"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert got.to_json() == want.to_json()


def test_h100_constants_and_links():
    hw = an.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.hbm_bytes) == (989e12, 3.35e12,
                                                        80e9)
    # The production meshes' 16-wide model axis spans two 8-GPU nodes.
    assert an.HW.for_mesh({"data": 16, "model": 16}).link_bw == 50e9
    assert an.HW.for_mesh({"pod": 2, "data": 16, "model": 16}).link_bw \
        == 50e9
    assert an.HW.for_mesh({"data": 2, "model": 4}).link_bw == 450e9
    assert an.HW.for_mesh({}).link_bw == 450e9


_COLLECTIVES = r"""
import json, logging
logging.disable(logging.WARNING)
import torch
import torch.distributed._functional_collectives as fc
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor, Shard, Replicate
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import (TraceCounter,
                                           collective_bytes_from_trace)
mesh = make_production_mesh(shape=(2, 4), axes=("data", "model"))
model_pg = mesh.get_group("model")
with FakeTensorMode():
    a = torch.zeros(1024, 16, dtype=torch.bfloat16)   # 32,768 bytes
    b = torch.zeros(64, 8)                              # 2,048 bytes
    def collectives():
        fc.wait_tensor(fc.all_gather_tensor(a, 0, model_pg))
        fc.wait_tensor(fc.all_gather_tensor(a, 0, model_pg))
        fc.wait_tensor(fc.all_reduce(b, "sum", model_pg))
        fc.wait_tensor(fc.reduce_scatter_tensor(a, "sum", 0, model_pg))
        fc.wait_tensor(fc.all_to_all_single(b, None, None, model_pg))
    out = {"coll": collective_bytes_from_trace(collectives)}
    # A product split over model on its contraction dim: the local share.
    x = distribute_tensor(torch.zeros(32, 64), mesh, [Shard(0), Shard(1)])
    w = distribute_tensor(torch.zeros(64, 48), mesh, [Replicate(), Shard(0)])
    counter = TraceCounter()
    with counter:
        y = x @ w
    with FlopCounterMode(display=False) as whole:
        torch.zeros(32, 64) @ torch.zeros(64, 48)
    out["local_flops"] = counter.flops
    out["global_flops"] = whole.get_total_flops()
    out["placements"] = str(y.placements)
print(json.dumps(out))
"""


def test_collective_bytes_and_local_flops_on_the_fake_group():
    res = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["coll"] == {"all-gather": 2 * 32768, "all-reduce": 2048,
                           "reduce-scatter": 32768, "all-to-all": 2048}
    # Each device multiplies its 16 x 16 block by 16 x 48: 1/8 of the
    # global product (split 2 ways on rows, 4 on the contraction).
    assert out["global_flops"] == 2 * 32 * 64 * 48
    assert out["local_flops"] == out["global_flops"] // 8
    assert "Partial" in out["placements"]


def _rec(arch, shape, mesh, status="ok", **kw):
    r = {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
         "wall_s": 12.5}
    if status == "ok":
        rep = an.RooflineReport(
            arch=arch, shape=shape, mesh=mesh, chips=256,
            flops_per_device=1e13, bytes_per_device=1e12,
            collective_bytes_per_device=2e11, coll_breakdown={},
            peak_memory_per_device=3e10, model_flops=2e15)
        r.update(rep.to_json())
    r.update(kw)
    return r


def test_report_renders_tables(tmp_path):
    recs = [_rec("qwen2-1.5b", "train_4k", "single"),
            _rec("qwen2-1.5b", "long_500k", "single", status="skipped",
                 reason="long_500k skipped"),
            _rec("qwen2-7b", "prefill_32k", "single", status="failed",
                 error="X"),
            _rec("qwen2-1.5b", "train_4k", "card"),
            {"arch": "lsmgraph-service", "shape": "V1_E1", "mesh": "single",
             "status": "ok", "collective_bytes_per_device": 5.5e6,
             "peak_memory_per_device": 4.4e7}]
    for r in recs:
        d = tmp_path / r["mesh"]
        d.mkdir(exist_ok=True)
        (d / f"{r['arch']}__{r['shape']}.json").write_text(json.dumps(r))
    loaded = report.load_records(str(tmp_path))
    assert len(loaded) == len(recs)
    summary = report.dryrun_summary(loaded)
    assert "**single**: 2 ok / 1 skipped (documented) / 1 failed of 4" \
        in summary
    assert "**card**: 1 ok" in summary and "multipod" not in summary
    table = report.roofline_table(loaded, "single")
    lines = table.splitlines()
    assert len(lines) == 2 + 4
    assert "| qwen2-1.5b | train_4k | 10.1ms | 298.5ms | 4.00s | " \
           "collective | 30.0GB |" in table
    assert "| qwen2-1.5b | long_500k | — | — | — | skipped |" in table
    assert "FAILED" in table and "110us/run" in table
    matrix = report.sweep_matrix(loaded).splitlines()
    assert matrix[0] == ("| arch | train_4k | prefill_32k | decode_32k | "
                         "long_500k |")
    assert len(matrix) == 2 + len(ARCH_IDS)
    row = next(r for r in matrix if r.startswith("| qwen2-1.5b |"))
    assert row == ("| qwen2-1.5b | L 12 / - / L 12 | - / - / - | "
                   "- / - / - | skip / - / - |")
    assert "FAIL / - / -" in next(r for r in matrix
                                  if r.startswith("| qwen2-7b |"))
    # The fill tool writes the same into a target's markers.
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import fill_experiments_torch as fill
    finally:
        sys.path.pop(0)
    text = fill.fill("# E\n\n<!-- DRYRUN_SUMMARY -->\nold\n\n## T\n\n"
                     "<!-- ROOFLINE_TABLE -->\nold\n", loaded)
    assert "old" not in text and summary in text and table in text
    assert "### One card (H100)" in text
