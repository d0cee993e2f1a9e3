"""Shard meshes of the port: a one-axis handle over a ``torch.distributed``
process group (port of ``repro.launch.mesh``).

The reference's mesh is a ``jax.sharding.Mesh`` whose ``data`` axis holds
one graph shard per device; its collectives run inside ``shard_map``.  The
port runs one process (rank) a shard, and ``ShardMesh`` is the handle those
ranks share: the axis names, the shape, the device each rank's tensors live
on and the process group that joins them.  It is not
``torch.distributed.device_mesh.DeviceMesh``: that picks NCCL for
``"cuda"``, and NCCL does not put two ranks of one communicator on the same
GPU, while the card this port runs on (one H100) holds all of a mesh's
shards.  So the ranks are joined by gloo.

Transport.  Gloo moves host memory; of its collectives only some take CUDA
tensors, and which ones depends on the build.  ``ShardMesh`` therefore
stages every collective on a CUDA tensor through the host: one helper
(``ShardMesh._exchange``) copies the input to the host, runs the collective
there and copies the result back, and counts the bytes it stages in
``staged_bytes``.  That is the design for shards that share a card, not a
fallback: a collective either runs this way or raises.  A mesh needs a
gloo group (NCCL across cards is not supported yet).

``make_production_mesh`` builds the reference's production meshes, (data
16, model 16) and (pod 2, data 16, model 16), as a ``DeviceMesh`` over
torch's fake process group: one process plays rank 0 of 256 or 512, its
collectives run nowhere, and the dry run (``launch.dryrun``) traces one
device's program on it under ``FakeTensorMode``.  ``init_fake_group`` is
the one place that starts that group.  The mesh ``card`` is no mesh at
all: one H100, a plain trace.

``spawn_ranks`` starts the ranks of a mesh on this host: fresh processes
(start method ``spawn``), one gloo group that meets through a file in a
new temporary directory (no port to pick, so none to lose to another
process before rank 0 binds it).
"""
from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Tuple

import torch
import torch.distributed as dist

from ..core.types import resolve_device
from ..models.partition import axis_names


class ShardMesh:
    """A mesh of ``shape`` over the ranks of ``group`` (``None``: the
    default group), each rank's tensors on ``device``."""

    def __init__(self, axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 device: torch.device, group=None) -> None:
        self.axis_names = tuple(axis_names)
        self.shape = tuple(shape)
        self.device = device
        self.group = group
        self.rank = dist.get_rank(group)
        #: Bytes copied between the device and the host for collectives.
        self.staged_bytes = 0

    def _size(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has axes {self.axis_names}, not {axis!r}")
        return self.shape[self.axis_names.index(axis)]

    def _exchange(self, collective, out: torch.Tensor,
                  inp: torch.Tensor) -> torch.Tensor:
        """``collective(out, inp)`` over the group.  A tensor on a device
        goes through host copies, counted in ``staged_bytes``."""
        if inp.device.type == "cpu":
            collective(out, inp)
            return out
        h_in = inp.cpu()
        h_out = torch.empty(out.shape, dtype=out.dtype)
        collective(h_out, h_in)
        out.copy_(h_out)
        self.staged_bytes += h_in.nbytes + h_out.nbytes
        return out

    def all_gather(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Every rank's 1-D ``t`` laid end to end in rank order (the
        reference's ``all_gather(tiled=True)``)."""
        n = self._size(axis)
        out = torch.empty((n * t.shape[0],), dtype=t.dtype, device=t.device)
        return self._exchange(
            lambda o, i: dist.all_gather(list(o.chunk(n)), i,
                                         group=self.group),
            out, t.contiguous())

    def all_reduce(self, t: torch.Tensor, op,
                   axis: str = "data") -> torch.Tensor:
        """``t`` reduced by ``op`` (a ``dist.ReduceOp``) over the ranks, as
        a new tensor (``psum`` and ``pmax`` of the reference)."""
        self._size(axis)

        def reduce(o, i):
            o.copy_(i)
            dist.all_reduce(o, op=op, group=self.group)
        return self._exchange(reduce, torch.empty_like(t), t)

    def all_to_all(self, t: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """``t`` cut into as many equal chunks as ranks along dim 0; chunk j
        goes to rank j, and the result holds the chunks received, in rank
        order (the reference's ``all_to_all(split_axis=0, concat_axis=0)``).
        """
        n = self._size(axis)
        if t.shape[0] % n:
            raise ValueError(f"dim 0 ({t.shape[0]}) does not split into {n}")
        return self._exchange(
            lambda o, i: dist.all_to_all_single(o, i, group=self.group),
            torch.empty_like(t), t.contiguous())


def make_shard_mesh(n_shards: int, *, device=None, group=None) -> ShardMesh:
    """1-D mesh over the ``data`` axis for the sharded graph service: one
    shard a rank.  Needs an initialised process group of ``n_shards``
    ranks (``spawn_ranks`` makes one).  ``device=None`` is the current CUDA
    card (raises when there is none); the tests pass ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_shard_mesh needs an initialised "
                           "torch.distributed process group")
    if dist.get_backend(group) != "gloo":
        raise ValueError("a shard mesh needs a gloo process group")
    size = dist.get_world_size(group)
    if size != n_shards:
        raise ValueError(f"the process group has {size} ranks, not "
                         f"{n_shards}")
    return ShardMesh(("data",), (n_shards,), resolve_device(device), group)


#: The dry run's meshes: name -> (shape, axis names); ``card`` is one card
#: and no mesh.
PRODUCTION_MESHES = {
    "single": ((16, 16), ("data", "model")),
    "multipod": ((2, 16, 16), ("pod", "data", "model")),
    "card": ((), ()),
}


def init_fake_group(world_size: int) -> None:
    """Start torch's fake process group of ``world_size`` ranks (this
    process is rank 0); a fake group of another size is replaced.  A
    process holds one default group: a fake group and the gloo ranks of
    ``spawn_ranks`` never share a process."""
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"already initialised")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu",
                         shape=None, axes=None):
    """Single pod: (data=16, model=16) = 256 cards.  Multi-pod: (pod=2,
    data=16, model=16) = 512 cards.  A ``DeviceMesh`` of ``device_type``
    over the fake process group (``shape`` and ``axes`` give another
    mesh, as the tests' (data 2, model 4)).  Tracing on it needs
    ``roofline.analysis.patch_dtensor_tracing``, which this applies."""
    from torch.distributed.device_mesh import init_device_mesh
    from ..roofline.analysis import patch_dtensor_tracing
    if shape is None:
        shape, axes = PRODUCTION_MESHES["multipod" if multi_pod
                                        else "single"]
    n = 1
    for d in shape:
        n *= d
    init_fake_group(n)
    patch_dtensor_tracing()
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def dp_axes(mesh) -> tuple:
    """The data-parallel axis bundle: ('pod','data') on multi-pod meshes."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n


def _rank_main(rank: int, n_ranks: int, init_file: str, results, fn,
               args) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=n_ranks, rank=rank)
    try:
        out = (True, fn(rank, n_ranks, *args))
    except Exception:  # reported to the parent, which raises it
        out = (False, traceback.format_exc())
    results.put((rank,) + out)
    dist.destroy_process_group()


def spawn_ranks(fn: Callable[..., Any], n_ranks: int, *args,
                timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, n_ranks, *args)`` in ``n_ranks`` fresh processes, each
    a member of one gloo group (``make_shard_mesh(n_ranks)`` in ``fn``
    gives its mesh), and return the results by rank.  ``fn``, ``args`` and
    the results are pickled.  Raises if a rank raises, exits without a
    result or outlives ``timeout`` seconds; every process is stopped before
    the call returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    rendezvous = tempfile.mkdtemp(prefix="lsmg-ranks-")
    init_file = os.path.join(rendezvous, "init")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, init_file, results, fn, args),
                         daemon=True) for r in range(n_ranks)]
    got: dict = {}
    deadline = time.monotonic() + timeout
    exited: list = []
    try:
        for p in procs:
            p.start()
        while len(got) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                # A rank's result reaches the queue before the rank exits;
                # one more empty wait after seeing it gone rules out a race.
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead and dead == exited:
                    raise RuntimeError(
                        f"rank(s) {dead} exited without a result (exit "
                        f"codes {[procs[r].exitcode for r in dead]})")
                exited = dead
                if time.monotonic() > deadline:
                    missing = sorted(set(range(n_ranks)) - set(got))
                    raise TimeoutError(f"rank(s) {missing} gave no result "
                                       f"in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n"
                                   f"{value}")
            got[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(rendezvous, ignore_errors=True)
    return [got[r] for r in range(n_ranks)]


__all__ = ["ShardMesh", "make_shard_mesh", "make_production_mesh",
           "init_fake_group", "PRODUCTION_MESHES", "axis_names", "dp_axes",
           "mesh_size", "spawn_ranks"]
