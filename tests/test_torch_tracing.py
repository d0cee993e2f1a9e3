"""The port's step spans: each is a ``torch.profiler`` range while a
profiler records and nothing more while none does, nested in its parent
span, and its histogram gains on its path and stays within its parent's.

The store is the small configuration of the obs tests; an ingest that
flushes and compacts, one resolve and one ``materialize_csr`` run every
step span once or more.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as torch_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.analytics import materialize_csr  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402

V = 1 << 10

#: Each step span and the spans it runs inside (any one of them).
PARENTS = {
    "store_apply_upload": ("store_apply",),
    "store_apply_claim": ("store_apply",),
    "store_apply_place": ("store_apply",),
    "store_apply_wait": ("store_apply",),
    "store_compaction_merge": ("store_compaction",),
    "store_run_seal": ("store_flush", "store_compaction"),
    "read_resolve_sealed": ("read_resolve",),
    "read_resolve_mem": ("read_resolve",),
    "read_resolve_host": ("read_resolve",),
    "analytics_view_collect": ("materialize_csr",),
    "analytics_view_merge": ("materialize_csr",),
}

#: Step histograms and the parent histograms whose sum bounds theirs.
STEPS = {
    ("store_apply_upload", "store_apply_claim", "store_apply_place",
     "store_apply_wait"): ("store_apply",),
    ("store_compaction_merge",): ("store_compaction",),
    ("store_run_seal",): ("store_flush", "store_compaction"),
    ("read_resolve_sealed", "read_resolve_mem",
     "read_resolve_host"): ("read_resolve",),
}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(**kw):
    cfg = dict(vmax=1 << 12, mem_edges=1 << 10, seg_size=4,
               n_segments=1 << 10, hash_slots=1 << 12, ovf_cap=1 << 12,
               batch_cap=256, l0_run_limit=2, seg_target_edges=1 << 10)
    cfg.update(kw)
    return LSMGraph(StoreConfig(**cfg), device="cpu")


def _workload(g):
    """An ingest that flushes and compacts into L1, a resolve, and a view
    build over the MemGraph and the runs."""
    rng = np.random.default_rng(7)
    for _ in range(6):
        g.insert_edges(rng.integers(0, V, 512), rng.integers(0, V, 512))
    g.delete_edges(np.arange(50), np.arange(50) + 1)
    g.insert_edges(rng.integers(0, V, 200), rng.integers(0, V, 200))
    with g.snapshot() as snap:
        snap.neighbors_batch(np.arange(V, dtype=np.int64))
        with torch.profiler.record_function("materialize_csr"):
            materialize_csr(snap, V)
    assert g.level_sizes()[1] > 0 and g.level_sizes()[0] > 0


def _totals():
    """(sum, count) of every histogram, over its series."""
    out = {}
    for inst in obs.REGISTRY.collect():
        if isinstance(inst, obs.Histogram):
            s, n = out.get(inst.name, (0.0, 0))
            out[inst.name] = (s + inst.sum, n + inst.count)
    return out


def _gained(before, after, name):
    s0, n0 = before.get(name, (0.0, 0))
    s1, n1 = after.get(name, (0.0, 0))
    return s1 - s0, n1 - n0


def test_step_ranges_nest_in_their_parents_under_the_profiler():
    g = _store()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _workload(g)
    g.close()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        ranges.setdefault(e.name(), []).append(
            (e.start_ns(), e.end_ns(), e.start_thread_id()))
    for step, parents in PARENTS.items():
        assert ranges.get(step), f"no {step} range"
        outer = [r for p in parents for r in ranges.get(p, [])]
        for lo, hi, tid in ranges[step]:
            assert any(plo <= lo and hi <= phi and ptid == tid
                       for plo, phi, ptid in outer), \
                f"{step} at {lo} is in none of {parents}"


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    entered = []
    real = torch_profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch_profiler, "record_function", counting)
    g = _store()
    _workload(g)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        g.insert_edges(np.arange(10), np.arange(10) + 2)
    g.close()
    assert {"store_apply", "store_apply_claim"} <= set(entered)


def test_step_histograms_gain_within_their_parents():
    g = _store()
    before = _totals()
    _workload(g)
    after = _totals()
    g.close()
    for steps, parents in STEPS.items():
        total = 0.0
        for step in steps:
            s, n = _gained(before, after, step + "_seconds")
            assert n > 0 and s > 0, step
            total += s
        bound = sum(_gained(before, after, p + "_seconds")[0]
                    for p in parents)
        assert total <= bound, (steps, total, bound)
    rounds, chunks = _gained(before, after, "store_apply_claim_rounds")
    applies = _gained(before, after, "store_apply_seconds")[1]
    assert chunks == applies and rounds >= chunks
    for step in ("analytics_view_collect", "analytics_view_merge"):
        assert _gained(before, after, step + "_seconds")[1] == 1, step


def test_array_only_ablation_times_no_apply_steps():
    g = _store(memcache_mode="array_only")
    before = _totals()
    rng = np.random.default_rng(3)
    g.insert_edges(rng.integers(0, V, 300), rng.integers(0, V, 300))
    after = _totals()
    g.close()
    assert _gained(before, after, "store_apply_seconds")[1] == 2
    for name in ("store_apply_upload_seconds", "store_apply_claim_seconds",
                 "store_apply_place_seconds", "store_apply_wait_seconds",
                 "store_apply_claim_rounds"):
        assert _gained(before, after, name)[1] == 0, name
