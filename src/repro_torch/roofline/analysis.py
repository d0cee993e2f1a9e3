"""Three-term roofline from a traced step (the port of
``repro.roofline.analysis``).

    compute    = FLOPs_per_device       / peak_FLOP/s
    memory     = bytes_per_device       / HBM_bw
    collective = coll_bytes_per_device  / link_bw

The reference reads the terms from what XLA compiled: ``cost_analysis()``
for FLOPs and bytes, the optimised HLO for the collectives, and
``memory_analysis()`` for the peak.  There is no compiled program here.  A
dry run runs the step under ``FakeTensorMode`` (shapes and dtypes, no data)
and ``TraceCounter`` reads each op as it is dispatched:

* FLOPs: the formulas of ``torch.utils.flop_counter`` (``FlopCounterMode``'s
  registry, with its decompositions), applied to each device's LOCAL
  tensors.  A DTensor op is let through to the local ops it issues, so a
  sharded product counts one device's share, not the global product.  The
  registry holds only matrix-class ops (mm, bmm, addmm, convolutions,
  attention): elementwise work counts nothing, where XLA's
  ``cost_analysis`` counts it too.  ``flops_per_device`` is therefore not
  comparable with the reference's.
* bytes: the operand plus result bytes of every aten op that the eager
  step dispatches (views excepted), each at its logical size: an operand
  volume, not the HBM traffic of any program.  A broadcast operand counts
  at its expanded size, an in-place op's operand counts again as its
  result, and nothing allows for reuse in caches; on one H100 this volume
  over HBM's rate came to 1.59x the measured time of the training step it
  was counted on (``chip_smoke.py`` phase 14).  So ``t_memory`` (and the
  ``bottleneck`` that compares it, as the reference's does) is no memory
  bound until the count is held against a profiled step's DRAM bytes.
* collectives: the operand bytes of every ``_c10d_functional`` collective,
  by the reference's kind names (``collective_bytes_from_trace``).
* peak: ``torch.distributed._tools.mem_tracker.MemTracker`` over the same
  run (``peak_tracker``: its totals, not its per-module statistics), with
  the tensors that exist before the step (weights, optimizer state, batch,
  cache) registered as external.

Ops that DTensor runs on global fake tensors to learn an output's shape
(its sharding propagation) are not the device's work and are not counted.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import ModelConfig, ShapeConfig

# NVIDIA H100 SXM5 80 GB data sheet (dense rates, 700 W).
H100_BF16_FLOPS = 989e12          # bf16 tensor cores, dense
H100_HBM_BW = 3.35e12             # HBM3, B/s
H100_HBM_BYTES = 80e9
# NVLink 4 inside an 8-GPU HGX node: 900 GB/s per GPU, 450 GB/s each way.
NVLINK_BW = 450e9
# Across nodes: one 400 Gb/s NDR InfiniBand port per GPU.
IB_BW = 50e9
#: GPUs an NVLink domain joins (one HGX H100 node).
NODE_GPUS = 8


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM5 80 GB (per card).  ``link_bw`` is the slowest
    link the mesh's collectives cross (``for_mesh``)."""

    peak_flops: float = H100_BF16_FLOPS
    hbm_bw: float = H100_HBM_BW
    link_bw: float = IB_BW
    hbm_bytes: float = H100_HBM_BYTES

    @classmethod
    def for_mesh(cls, axis_sizes: Dict[str, int]) -> "HW":
        """The card for a mesh of ``axis_sizes`` (name -> size, minor axis
        last).  The minor axis's groups are contiguous GPUs: when one group
        fits in an 8-GPU node, and so does the whole mesh, NVLink carries
        every collective; otherwise some collective crosses nodes and the
        InfiniBand port per GPU bounds it.  The production meshes' 16-wide
        ``model`` axis spans two nodes, so both take ``IB_BW``; the
        one-card mesh has no collectives and keeps NVLink's rate."""
        total = 1
        for n in axis_sizes.values():
            total *= n
        return cls(link_bw=NVLINK_BW if total <= NODE_GPUS else IB_BW)


# --------------------------------------------------------------------------
# Tracing
# --------------------------------------------------------------------------

# The reference's kind names for torch's functional collectives.
_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}

# Metadata queries that FlopCounterMode also lets through.
_META_OPS = {
    torch.ops.aten.is_contiguous.default,
    torch.ops.aten.is_contiguous.memory_format,
    torch.ops.aten.is_strides_like_format.default,
    torch.ops.aten.is_non_overlapping_and_dense.default,
    torch.ops.aten.size.default,
    torch.ops.aten.sym_size.default,
    torch.ops.aten.stride.default,
    torch.ops.aten.sym_stride.default,
    torch.ops.aten.storage_offset.default,
    torch.ops.aten.sym_storage_offset.default,
    torch.ops.aten.numel.default,
    torch.ops.aten.sym_numel.default,
    torch.ops.aten.dim.default,
    torch.ops.prim.layout.default,
}

_tls = threading.local()


def _in_meta_propagation() -> bool:
    return getattr(_tls, "propagating", 0) > 0


@functools.lru_cache(maxsize=None)
def patch_dtensor_tracing() -> Dict[str, bool]:
    """Two adjustments to DTensor for tracing under ``FakeTensorMode``,
    made once a process; -> whether each was installed (``shape_probe``,
    ``strided_offsets``), since each torch release names these internals
    its own way.  A mesh trace without ``shape_probe`` would count the
    probes as device work, so ``launch.dryrun`` refuses it.

    * DTensor runs an op on global fake tensors to learn the shape of its
      output; a flag marks those calls so ``TraceCounter`` skips them;
    * ``_StridedShard`` (a dim merged from two split dims, such as batch x
      sequence in a product) works out its shard's offsets with a real
      ``arange`` and ``tolist``, which fails on fake tensors: it runs with
      fake mode suspended (the offsets are plain integers)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def wrap(owner, name: str, around) -> bool:
        fn = owner.__dict__.get(name)
        if fn is None:
            return False
        static = isinstance(fn, staticmethod)
        inner = fn.__func__ if static else fn

        @functools.wraps(inner)
        def wrapped(*args, **kwargs):
            with around():
                return inner(*args, **kwargs)
        setattr(owner, name, staticmethod(wrapped) if static else wrapped)
        return True

    @contextlib.contextmanager
    def probing():
        _tls.propagating = getattr(_tls, "propagating", 0) + 1
        try:
            yield
        finally:
            _tls.propagating -= 1
    probe = any(wrap(ShardingPropagator, name, probing)
                for name in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                if name in ShardingPropagator.__dict__)
    strided = getattr(placement_types, "_StridedShard", None)
    return {"shape_probe": probe,
            "strided_offsets": strided is not None and wrap(
                strided, "local_shard_size_and_offset",
                unset_fake_temporarily)}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class TraceCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes and collective bytes of the ops dispatched
    under it (module docstring).  ``flops`` and ``bytes`` are totals;
    ``collectives`` maps a kind to its operand bytes."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        self.registry = FlopCounterMode().flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if func in _META_OPS or any(issubclass(t, DTensor) for t in types):
            return NotImplemented   # a DTensor op: count its local ops
        if isinstance(func, torch._ops.HigherOrderOperator):
            return NotImplemented
        if _in_meta_propagation():
            return func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + _nbytes(args[0]))
            return func(*args, **kwargs)
        # FlopCounterMode's rule: an op with no formula is decomposed.
        if func not in self.registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += (_nbytes(list(args)) + _nbytes(list(kwargs.values()))
                           + _nbytes(out))
        return out


def collective_bytes_from_trace(fn: Callable, *args, **kwargs
                                ) -> Dict[str, int]:
    """Operand bytes by collective kind of the ``_c10d_functional``
    collectives that ``fn(*args, **kwargs)`` dispatches (the counterpart of
    ``collective_bytes_from_hlo``: a trace instead of an HLO text)."""
    counter = TraceCounter()
    with counter:
        fn(*args, **kwargs)
    return dict(counter.collectives)


@dataclasses.dataclass
class TraceStats:
    flops: float
    bytes: float
    collectives: Dict[str, int]
    peak: float
    peak_breakdown: Dict[str, float]


def peak_tracker():
    """A ``MemTracker`` that keeps the device totals and their peak but
    no per-module statistics: its module hooks refuse a module that runs
    twice in a step (a layer recomputed under remat, the model run once a
    micro-batch).  It also skips DTensor's probes on global fake tensors,
    which it cannot tell from the step's own ops under one fake mode.  The
    tensors that exist before the step are registered with
    ``track_external``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class PeakTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _in_meta_propagation():   # DTensor's global shape probe
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

        def _pre_fw_hook(self, module, inputs):
            pass

        def _post_fw_hook(self, module, inputs, outputs):
            pass

        def _pre_bw_hook(self, module, args):
            pass

        def _post_bw_hook(self, module, args):
            pass
    return PeakTracker()


def trace_step(fn: Callable, external: Iterable = (),
               device: Optional[torch.device] = None):
    """Run ``fn()`` under a ``TraceCounter`` and a ``MemTracker`` (with
    ``external``, the tensors that exist before the step, registered) and
    return ``(fn's result, TraceStats)``.  The peak is ``MemTracker``'s
    total on ``device`` (default: the device of the first external
    tensor)."""
    patch_dtensor_tracing()
    ext = [t for t in external if isinstance(t, torch.Tensor)]
    mt = peak_tracker()
    if ext:
        mt.track_external(*ext)
    counter = TraceCounter()
    with mt:
        with counter:
            out = fn()
    snap = mt.get_tracker_snapshot("peak")
    if device is None:
        device = ext[0].device if ext else next(iter(snap))
    if isinstance(device, str):
        device = torch.device(device)
    per_dev = snap.get(device, {})
    if not per_dev:   # a CUDA index the snapshot keys differently
        per_dev = next((v for k, v in snap.items()
                        if k.type == device.type), {})
    breakdown = {str(getattr(k, "value", k)): float(v)
                 for k, v in per_dev.items()}
    return out, TraceStats(flops=float(counter.flops),
                           bytes=float(counter.bytes),
                           collectives=dict(counter.collectives),
                           peak=float(per_dev.get("Total", 0.0)),
                           peak_breakdown=breakdown)


# --------------------------------------------------------------------------
# The report
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    peak_memory_per_device: float
    model_flops: float

    hw: HW = dataclasses.field(default_factory=HW)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        """The operand volume over HBM's rate: no memory bound (module
        docstring)."""
        return self.bytes_per_device / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound step time:
        t_model_compute / max(all terms)."""
        t_model = (self.model_flops / self.chips) / self.hw.peak_flops
        t_bound = max(self.t_compute, self.t_memory, self.t_collective,
                      1e-30)
        return t_model / t_bound

    @property
    def useful_flops_ratio(self) -> float:
        tot = self.flops_per_device * self.chips
        return self.model_flops / tot if tot else 0.0

    def to_json(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_per_device": self.peak_memory_per_device,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N_active·D for training, 2·N_active·D for inference
    (per step: prefill D = B·S tokens; decode D = B tokens)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_active * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_active * toks
    return 2.0 * n_active * shape.global_batch  # decode: one token/seq


def analyze_trace(stats: TraceStats, *, arch: str, shape_cfg: ShapeConfig,
                  cfg: ModelConfig, mesh_name: str, chips: int,
                  hw: Optional[HW] = None) -> RooflineReport:
    """The report of a traced step (the counterpart of
    ``analyze_compiled``)."""
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        flops_per_device=stats.flops, bytes_per_device=stats.bytes,
        collective_bytes_per_device=float(sum(stats.collectives.values())),
        coll_breakdown=dict(stats.collectives),
        peak_memory_per_device=stats.peak,
        model_flops=model_flops(cfg, shape_cfg),
        hw=hw if hw is not None else HW())
