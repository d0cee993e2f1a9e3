"""Property-based tests (hypothesis) of the port's store and multi-level
analytics, against the JAX package's.

The two store cases of the reference's ``tests/test_property.py`` that no
port test answered (its ``CompactIndex`` case is in
``test_torch_baselines.py``): every generated insert/delete sequence runs
through a JAX ``LSMGraph`` and a port ``LSMGraph`` on the CPU.

* ``test_store_matches_dict_model``: the port's adjacency equals the
  reference's for every vertex.  The generator re-inserts live pairs,
  which is what the reference's compaction fault 1 (a resurrected delete,
  which the port reproduces) needs, so the port is held to the reference,
  and through it to the dict model wherever the reference meets it.
* ``test_multilevel_spmv_equals_materialized``: ± tombstone annihilation
  (``multilevel_degree``) equals the exact merge (``materialize_csr``'s
  degrees) within 1e-4, the reference's tolerance, and both equal the
  reference's values (integers in float32: exactly).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip(
    "hypothesis",
    reason="hypothesis not installed (see requirements-dev.txt); property "
           "tests are skipped rather than breaking suite collection")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from conftest import small_store_cfg  # noqa: E402
from repro.core import LSMGraph as JaxGraph  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402

_sets = settings(max_examples=20, deadline=None,
                 suppress_health_check=list(HealthCheck))
_CFG = dict(vmax=64, mem_edges=64, batch_cap=32, n_segments=256,
            hash_slots=512, ovf_cap=512, seg_target_edges=128)


@st.composite
def op_sequences(draw):
    """The reference's generator (tests/test_property.py)."""
    n_ops = draw(st.integers(3, 12))
    ops = []
    live = set()
    for _ in range(n_ops):
        kind = draw(st.sampled_from(["insert", "insert", "insert", "delete"]))
        k = draw(st.integers(1, 60))
        src = draw(st.lists(st.integers(0, 40), min_size=k, max_size=k))
        dst = draw(st.lists(st.integers(0, 40), min_size=k, max_size=k))
        if kind == "delete":
            if not live:
                continue
            pool = list(live)
            idx = draw(st.lists(st.integers(0, len(pool) - 1),
                                min_size=1, max_size=min(8, len(pool))))
            pairs = [pool[i] for i in idx]
            ops.append(("delete", pairs))
            live -= set(pairs)
        else:
            pairs = list(zip(src, dst))
            ops.append(("insert", pairs))
            live |= set(pairs)
    return ops


def _pair():
    cfg = small_store_cfg(**_CFG)
    return (JaxGraph(cfg),
            LSMGraph(StoreConfig(**dataclasses.asdict(cfg)), device="cpu"))


def _apply(gs, kind, pairs):
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    for g in gs:
        (g.insert_edges if kind == "insert" else g.delete_edges)(src, dst)


@given(op_sequences())
@_sets
def test_store_matches_dict_model(ops):
    gs = _pair()
    model = {}
    for kind, pairs in ops:
        _apply(gs, kind, pairs)
        for p in pairs:
            if kind == "insert":
                model.setdefault(p[0], set()).add(p[1])
            else:
                model.get(p[0], set()).discard(p[1])
    snaps = [g.snapshot() for g in gs]
    for v in range(41):
        want, got = (set(int(x) for x in s.neighbors(v)) for s in snaps)
        assert got == want, (v, got, want)
    for s in snaps:
        s.release()


@given(op_sequences())
@_sets
def test_multilevel_spmv_equals_materialized(ops):
    """± tombstone annihilation == exact merge for alternating histories."""
    from repro import analytics as jan
    from repro_torch import analytics as pan
    gs = _pair()
    seen = set()
    for kind, pairs in ops:
        if kind == "insert":
            # no dup live inserts (within a batch or across batches)
            pairs = [p for p in dict.fromkeys(pairs) if p not in seen]
            seen |= set(pairs)
        else:
            # no double-deletes: histories must alternate ins/del
            pairs = [p for p in dict.fromkeys(pairs) if p in seen]
            seen -= set(pairs)
        if pairs:
            _apply(gs, kind, pairs)
    jsnap, psnap = (g.snapshot() for g in gs)
    deg_exact = pan.materialize_csr(psnap, 64).degrees.numpy().astype(
        np.float32)
    deg_fast = pan.multilevel_degree(pan.multilevel_views(psnap), n_out=64,
                                     use_pallas=False).numpy()
    np.testing.assert_allclose(deg_fast, deg_exact, atol=1e-4)
    want_exact = np.asarray(jan.materialize_csr(jsnap, 64).degrees)
    want_fast = np.asarray(jan.multilevel_degree(
        jan.multilevel_views(jsnap), n_out=64, use_pallas=False))
    np.testing.assert_array_equal(deg_exact, want_exact.astype(np.float32))
    np.testing.assert_array_equal(deg_fast, want_fast)
    jsnap.release()
    psnap.release()
