"""The port's distributed graph layer (``repro_torch.core.distributed``,
``repro_torch.launch.mesh`` and ``repro_torch.shard.make_mesh_write_router``)
against the JAX package's.

Answers the reference's ``tests/test_distributed.py`` (PageRank with each
exchange, the update router) and
``tests/test_shard.py::test_mesh_write_router_routes_markers``.  Each
package runs once, in a subprocess of its own: the reference on 8 host
devices (``XLA_FLAGS``), the port as 8 gloo ranks on the CPU
(``spawn_ranks``), with 4- and 3-rank subgroups for the write router and
for the reference's fault 6.  Inputs are made here from numpy seeds and
handed to both in one ``.npz``.

Tolerances: the partition and every routed array byte-equal; fp32
PageRank within 1e-6 (absolute, the reference's bound) of the reference's
distributed and single-store results; bf16 and int8 within 2e-2 and 5e-2
of the single-store result, relative to its largest rank, as the
reference measures them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.slow

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
EXCHANGE_BOUND = {"bf16": 2e-2, "int8": 5e-2}   # tests/test_distributed.py
# The update router's shapes (tests/test_distributed.py), once as there
# and once with buckets small enough to drop records.
ROUTER_CASES = {"cap32": dict(v_local=32, batch_cap=64, bucket_cap=32),
                "cap4": dict(v_local=32, batch_cap=64, bucket_cap=4)}
# The mesh write router (tests/test_shard.py): 4 shards of 128 vertices.
MESH_S, MESH_V, MESH_CAP = 4, 128, 32
# The reference's fault 6: V % n_shards != 0.
FAULT6 = dict(V=10, E=40, S=3)


def _graph(V, E, seed=3):
    """tests/test_distributed.py's generator: (voff, dst) of E random
    edges over V vertices."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, V, E)).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    voff = np.searchsorted(src, np.arange(V + 1)).astype(np.int32)
    return voff, dst


def _inputs(path):
    arrs = {}
    arrs["voff"], arrs["dst"] = _graph(256, 4000)
    arrs["f6_voff"], arrs["f6_dst"] = _graph(FAULT6["V"], FAULT6["E"])
    rng = np.random.default_rng(5)
    n = N_RANKS * 64
    arrs["r_src"] = rng.integers(0, 256, n).astype(np.int32)
    arrs["r_dst"] = rng.integers(0, 256, n).astype(np.int32)
    arrs["r_prop"] = rng.random(n).astype(np.float32)
    arrs["r_nv"] = rng.integers(40, 65, N_RANKS).astype(np.int32)
    rng = np.random.default_rng(1)
    n = MESH_S * 2 * MESH_CAP
    arrs["m_src"] = rng.integers(0, MESH_V, n).astype(np.int32)
    arrs["m_dst"] = rng.integers(0, MESH_V, n).astype(np.int32)
    arrs["m_prop"] = rng.random(n).astype(np.float32)
    arrs["m_marker"] = rng.random(n) < 0.3
    arrs["m_nv"] = np.full((MESH_S,), 2 * MESH_CAP, np.int32)
    np.savez(path, **arrs)


_REF_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.analytics import pagerank
from repro.analytics.view import CSRView
from repro.core.distributed import (make_distributed_pagerank,
                                    make_route_updates, partition_csr)
from repro.launch.mesh import dp_axes, make_shard_mesh, mesh_size
from repro.shard import RangePartition, make_mesh_write_router

inp = dict(np.load(sys.argv[1]))
ROUTER_CASES, MESH, OUT = json.loads(sys.argv[2]), json.loads(sys.argv[3]), \
    sys.argv[4]
out = {}


def view_of(voff, dst):
    V, E = len(voff) - 1, len(dst)
    return CSRView(voff=jnp.asarray(voff), dst=jnp.asarray(dst),
                   prop=jnp.ones(E, jnp.float32), n_vertices=V, n_edges=E)


def mesh_of(k):
    return Mesh(np.array(jax.devices()[:k]), ("data",))


for tag, voff, dst, S in (("g", inp["voff"], inp["dst"], 8),
                          ("f6", inp["f6_voff"], inp["f6_dst"], 3)):
    view = view_of(voff, dst)
    shard = partition_csr(view, S)
    for f in ("dst", "seg", "wt", "deg", "v_start"):
        out[f"{tag}_part_{f}"] = np.asarray(getattr(shard, f))
    out[f"{tag}_single"] = np.asarray(pagerank(view, iters=10,
                                               use_pallas=False))
    for ex in ("fp32", "bf16", "int8"):
        if tag == "f6" and ex != "fp32":
            continue
        out[f"{tag}_pr_{ex}"] = np.asarray(make_distributed_pagerank(
            mesh_of(S), shard, iters=10, exchange=ex)())

mesh8 = make_shard_mesh(8)
out["dp_axes"] = np.array(dp_axes(mesh8))
out["mesh_size"] = np.array(mesh_size(mesh8))
for case, kw in ROUTER_CASES.items():
    router = make_route_updates(mesh8, n_shards=8, **kw)
    res = router(*(jnp.asarray(inp[k]) for k in ("r_src", "r_dst", "r_prop",
                                                 "r_nv")))
    for name, a in zip(("src", "dst", "prop", "valid", "dropped"), res):
        out[f"{case}_{name}"] = np.asarray(a)

part = RangePartition.for_vmax(MESH["V"], MESH["S"])
router = make_mesh_write_router(mesh_of(MESH["S"]), part,
                                bucket_cap=MESH["CAP"])
res = router(*(jnp.asarray(inp[k]) for k in ("m_src", "m_dst", "m_prop",
                                             "m_marker", "m_nv")))
for name, a in zip(("src", "dst", "prop", "marker", "valid", "dropped"),
                   res):
    out[f"mesh_{name}"] = np.asarray(a)
np.savez(OUT, **out)
print("ok")
"""

_PORT_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.analytics import pagerank
from repro_torch.analytics.view import CSRView
from repro_torch.core.distributed import (make_distributed_pagerank,
                                          make_route_updates, partition_csr)
from repro_torch.launch.mesh import (dp_axes, make_shard_mesh, mesh_size,
                                     spawn_ranks)
from repro_torch.shard import RangePartition, make_mesh_write_router


def view_of(voff, dst):
    V, E = len(voff) - 1, len(dst)
    return CSRView(voff=torch.from_numpy(voff), dst=torch.from_numpy(dst),
                   prop=torch.ones(E), n_vertices=V, n_edges=E)


def rank_main(rank, n, inputs, router_cases, mesh_cfg):
    inp = dict(np.load(inputs))
    out = {}
    mesh8 = make_shard_mesh(n, device="cpu")
    # Subgroups are made by every rank, in the same order.
    g4 = dist.new_group(list(range(mesh_cfg["S"])))
    g3 = dist.new_group([0, 1, 2])
    out["dp_axes"] = np.array(dp_axes(mesh8))
    out["mesh_size"] = np.array(mesh_size(mesh8))
    meshes = {"g": mesh8}
    if rank < 3:
        meshes["f6"] = make_shard_mesh(3, device="cpu", group=g3)
    for tag, mesh in meshes.items():
        view = view_of(inp[f"{tag}_voff"] if tag == "f6" else inp["voff"],
                       inp[f"{tag}_dst"] if tag == "f6" else inp["dst"])
        shard = partition_csr(view, 8 if tag == "g" else 3)
        if rank == 0:
            for f in ("dst", "seg", "wt", "deg", "v_start"):
                out[f"{tag}_part_{f}"] = getattr(shard, f)
            out[f"{tag}_single"] = pagerank(view, iters=10).numpy()
        for ex in ("fp32", "bf16", "int8"):
            if tag == "f6" and ex != "fp32":
                continue
            out[f"{tag}_pr_{ex}"] = make_distributed_pagerank(
                mesh, shard, iters=10, exchange=ex)().numpy()
    b = 64
    lo = slice(rank * b, (rank + 1) * b)
    for case, kw in router_cases.items():
        router = make_route_updates(mesh8, n_shards=n, **kw)
        res = router(torch.from_numpy(inp["r_src"][lo]),
                     torch.from_numpy(inp["r_dst"][lo]),
                     torch.from_numpy(inp["r_prop"][lo]),
                     int(inp["r_nv"][rank]))
        for name, a in zip(("src", "dst", "prop", "valid", "dropped"), res):
            out[f"{case}_{name}"] = a.numpy()
    if rank < mesh_cfg["S"]:
        mesh = make_shard_mesh(mesh_cfg["S"], device="cpu", group=g4)
        part = RangePartition.for_vmax(mesh_cfg["V"], mesh_cfg["S"])
        router = make_mesh_write_router(mesh, part,
                                        bucket_cap=mesh_cfg["CAP"])
        b = 2 * mesh_cfg["CAP"]
        lo = slice(rank * b, (rank + 1) * b)
        res = router(*(torch.from_numpy(inp[k][lo])
                       for k in ("m_src", "m_dst", "m_prop", "m_marker")),
                     torch.from_numpy(inp["m_nv"][rank:rank + 1]))
        for name, a in zip(("src", "dst", "prop", "marker", "valid",
                            "dropped"), res):
            out[f"mesh_{name}"] = a.numpy()
        out["mesh_staged"] = np.array(mesh.staged_bytes)
    out["staged"] = np.array(mesh8.staged_bytes)
    return out


if __name__ == "__main__":
    inputs, cases, mesh_cfg, dest = sys.argv[1:5]
    per_rank = spawn_ranks(rank_main, 8, inputs, json.loads(cases),
                           json.loads(mesh_cfg), timeout=300)
    out = {}
    for rank, res in enumerate(per_rank):
        for k, v in res.items():
            out[f"r{rank}_{k}"] = v
    np.savez(dest, **out)
    print("ok")
"""


def _run(script_args, env_extra, tmp):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **env_extra)
    out = subprocess.run([sys.executable, *script_args], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tmp)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist") / "inputs.npz"
    _inputs(path)
    return path


def _args(inputs, dest):
    return [str(inputs), json.dumps(ROUTER_CASES),
            json.dumps(dict(S=MESH_S, V=MESH_V, CAP=MESH_CAP)), str(dest)]


@pytest.fixture(scope="module")
def ref(inputs):
    dest = inputs.parent / "ref.npz"
    _run(["-c", _REF_SCRIPT, *_args(inputs, dest)],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=8",
          "JAX_PLATFORMS": "cpu"}, inputs.parent)
    return dict(np.load(dest))


@pytest.fixture(scope="module")
def port(inputs):
    script = inputs.parent / "port_ranks.py"
    script.write_text(_PORT_SCRIPT)
    dest = inputs.parent / "port.npz"
    _run([str(script), *_args(inputs, dest)], {}, inputs.parent)
    return dict(np.load(dest))


def _eq(want, got, what):
    assert want.dtype == got.dtype and want.shape == got.shape, \
        f"{what}: {want.dtype}{want.shape} vs {got.dtype}{got.shape}"
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("tag", ["g", "f6"])
@pytest.mark.parametrize("field", ["dst", "seg", "wt", "deg", "v_start"])
def test_partition_csr_byte_equal(ref, port, tag, field):
    key = f"{tag}_part_{field}"
    _eq(ref[key], port[f"r0_{key}"], key)


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_update_routing_byte_equal(inputs, ref, port, case):
    """Rank r's received buckets are the reference's shard r slice, byte for
    byte; the owner rule holds and every record sent is received or
    counted as dropped."""
    width = N_RANKS * ROUTER_CASES[case]["bucket_cap"]
    v_local = ROUTER_CASES[case]["v_local"]
    received = dropped = 0
    for r in range(N_RANKS):
        sl = slice(r * width, (r + 1) * width)
        for name in ("src", "dst", "prop", "valid"):
            _eq(ref[f"{case}_{name}"][sl], port[f"r{r}_{case}_{name}"],
                f"rank {r} {name}")
        _eq(ref[f"{case}_dropped"][r:r + 1], port[f"r{r}_{case}_dropped"],
            f"rank {r} dropped")
        valid = port[f"r{r}_{case}_valid"].astype(bool)
        assert np.all(port[f"r{r}_{case}_src"][valid] // v_local == r)
        received += int(valid.sum())
        dropped += int(port[f"r{r}_{case}_dropped"][0])
    assert received + dropped == int(np.load(inputs)["r_nv"].sum())
    assert (dropped == 0) == (case == "cap32")


def test_distributed_pagerank_fp32_matches_reference(ref, port):
    """Every rank returns the whole iterate; each is within 1e-6 of the
    reference's distributed and single-store PageRank."""
    V = 256
    for r in range(N_RANKS):
        got = port[f"r{r}_g_pr_fp32"]
        assert got.shape == ref["g_pr_fp32"].shape
        assert np.abs(got[:V] - ref["g_pr_fp32"][:V]).max() < 1e-6
        assert np.abs(got[:V] - ref["g_single"]).max() < 1e-6
    assert np.abs(port["r0_g_single"] - ref["g_single"]).max() < 1e-6


@pytest.mark.parametrize("exchange", sorted(EXCHANGE_BOUND))
def test_compressed_exchange_accuracy(ref, port, exchange):
    """bf16 / int8 iterate exchange keeps PageRank within the reference's
    bounds of the single-store result, relative to its largest rank (as
    the reference measures them), on every rank."""
    V, single = 256, ref["g_single"]
    want = np.abs(ref[f"g_pr_{exchange}"][:V] - single).max() / single.max()
    assert want < EXCHANGE_BOUND[exchange]
    for r in range(N_RANKS):
        got = port[f"r{r}_g_pr_{exchange}"][:V]
        err = np.abs(got - single).max() / single.max()
        assert err < EXCHANGE_BOUND[exchange], (r, err)


def test_mesh_write_router_routes_markers(inputs, ref, port):
    """make_mesh_write_router over 4 ranks: each rank's received records,
    markers included, are the reference's shard slice byte for byte; the
    owner rule holds and tombstone markers travel with their edges."""
    width = MESH_S * MESH_CAP
    v_local = -(-MESH_V // MESH_S)
    inp = np.load(inputs)
    received = dropped = markers = 0
    for r in range(MESH_S):
        sl = slice(r * width, (r + 1) * width)
        for name in ("src", "dst", "prop", "marker", "valid"):
            _eq(ref[f"mesh_{name}"][sl], port[f"r{r}_mesh_{name}"],
                f"rank {r} {name}")
        _eq(ref["mesh_dropped"][r:r + 1], port[f"r{r}_mesh_dropped"],
            f"rank {r} dropped")
        valid = port[f"r{r}_mesh_valid"].astype(bool)
        assert np.all(port[f"r{r}_mesh_src"][valid] // v_local == r)
        received += int(valid.sum())
        dropped += int(port[f"r{r}_mesh_dropped"][0])
        markers += int(port[f"r{r}_mesh_marker"][valid].sum())
    assert received + dropped == int(inp["m_nv"].sum())
    assert dropped == 0
    assert markers == int(inp["m_marker"].sum())
    # Over gloo on the CPU nothing is staged through the host.
    assert all(int(port[f"r{r}_mesh_staged"]) == 0 for r in range(MESH_S))


def test_fault6_pad_vertices_do_not_leak(ref, port):
    """The reference's fault 6: V = 10 over 3 shards (pad vertex 11).  The
    port's distributed PageRank equals the single-store PageRank; the
    reference's does not (its pad starts at 1/n and counts as dangling)."""
    V, single = FAULT6["V"], ref["f6_single"]
    for r in range(FAULT6["S"]):
        got = port[f"r{r}_f6_pr_fp32"]
        assert np.abs(got[:V] - single).max() < 1e-6
        assert np.all(got[V:] == 0.0)
    assert np.abs(ref["f6_pr_fp32"][:V] - single).max() > 1e-3


def test_shard_mesh_axes(ref, port):
    for r in range(N_RANKS):
        assert tuple(port[f"r{r}_dp_axes"]) == tuple(ref["dp_axes"]) \
            == ("data",)
        assert int(port[f"r{r}_mesh_size"]) == int(ref["mesh_size"]) == 8
