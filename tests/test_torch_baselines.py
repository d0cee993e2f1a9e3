"""The port's baseline systems (``repro_torch.baselines``) and its host-side
``CompactIndex`` against the JAX package's.

Both are numpy on the host in both packages.  The cases of
``tests/test_baselines.py`` and ``tests/test_complexity.py`` run on the
port's classes (the complexity cases with the port's ``LSMGraph`` on the
CPU); then each of the four baselines takes the same seeded stream in both
packages and must give equal ``neighbors``, snapshot CSR arrays and I/O
counters, and ``CompactIndex`` takes the same operations in both packages
(the case of ``tests/test_property.py`` under hypothesis, and a fixed
sequence that splits the page interval) and must give equal
``get_positions`` and ``nbytes()``.  Tolerance: none (integers, and float32
properties copied, never computed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from conftest import small_store_cfg  # noqa: E402
from repro import baselines as ref_baselines  # noqa: E402
from repro.core.index import CompactIndex as RefCompactIndex  # noqa: E402
from repro_torch.baselines import (CSRInplace, LlamaSnapshots,  # noqa: E402
                                   LogAppend, LSMKVStore)
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core.index import CompactIndex  # noqa: E402


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread while each test runs (restored after): the
    suite runs several workers on one machine, where every worker's
    spinning OpenMP threads would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


V = 200
SYSTEMS = {
    "csr_inplace": lambda m: m.CSRInplace(V),
    "lsm_kv": lambda m: m.LSMKVStore(V, mem_cap=256, l0_limit=2),
    "llama": lambda m: m.LlamaSnapshots(V, epoch_edges=256),
    "log_append": lambda m: m.LogAppend(V),
}


class _Port:
    CSRInplace, LSMKVStore = CSRInplace, LSMKVStore
    LlamaSnapshots, LogAppend = LlamaSnapshots, LogAppend


def _port_cfg():
    return StoreConfig(**dataclasses.asdict(small_store_cfg(vmax=1 << 12)))


# ------------------------------------------- the cases of test_baselines.py
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_baseline_neighbors_match_model(name):
    rng = np.random.default_rng(0)
    sys_ = SYSTEMS[name](_Port)
    model = {}
    for _ in range(4):
        src = rng.integers(0, V, 300)
        dst = rng.integers(0, V, 300)
        sys_.insert_edges(src, dst)
        for s, d in zip(src, dst):
            model.setdefault(int(s), set()).add(int(d))
        di = rng.integers(0, 300, 30)
        sys_.delete_edges(src[di], dst[di])
        for i in di:
            model.get(int(src[i]), set()).discard(int(dst[i]))
    for v in list(model)[:60]:
        got = set(int(x) for x in sys_.neighbors(v))
        assert got == model.get(v, set()), v


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_baseline_snapshot_csr(name):
    sys_ = SYSTEMS[name](_Port)
    sys_.insert_edges([1, 1, 2], [5, 6, 7])
    voff, dst, prop = sys_.snapshot_csr()
    assert voff[-1] == 3
    assert sorted(dst[voff[1]:voff[2]].tolist()) == [5, 6]


def test_design_asymmetries():
    """CSR in-place pays write amplification; the log pays read
    amplification."""
    rng = np.random.default_rng(1)
    csr_s, log_s = CSRInplace(V), LogAppend(V)
    for _ in range(10):
        src = rng.integers(0, V, 200)
        dst = rng.integers(0, V, 200)
        csr_s.insert_edges(src, dst)
        log_s.insert_edges(src, dst)
    assert csr_s.io.write > 5 * log_s.io.write      # CSR write amp
    r_log0, r_csr0 = log_s.io.read, csr_s.io.read
    _ = log_s.neighbors(3)
    _ = csr_s.neighbors(3)
    assert (log_s.io.read - r_log0) > 100 * (csr_s.io.read - r_csr0)


# ------------------------------------------ the cases of test_complexity.py
def _ingest_cost_curve(g, chunks, total_write):
    costs = []
    rng = np.random.default_rng(0)
    for _ in range(chunks):
        before = total_write(g)
        src = rng.integers(0, 4000, 2000)
        dst = rng.integers(0, 4000, 2000)
        g.insert_edges(src, dst)
        costs.append((total_write(g) - before) / 2000)
    return costs


def test_write_amortization_flat_vs_csr_linear():
    """LSMGraph's amortized write I/O per edge stays flat as |E| grows,
    the in-place CSR baseline's grows about linearly (Table 1)."""
    n = 25
    lsm = _ingest_cost_curve(LSMGraph(_port_cfg(), device="cpu"), n,
                             lambda g: g.io.total_write())
    csr = _ingest_cost_curve(CSRInplace(1 << 12), n, lambda g: g.io.write)
    assert csr[-1] > 5 * csr[0]
    assert max(lsm[-3:]) < 6 * (sum(lsm[:3]) / 3 + 1)
    assert sum(lsm[-5:]) / 5 < 0.85 * (sum(csr[-5:]) / 5)


def test_read_io_bounded_by_levels():
    """A point read touches at most O(L) runs per vertex."""
    g = LSMGraph(_port_cfg(), device="cpu")
    rng = np.random.default_rng(1)
    g.insert_edges(rng.integers(0, 1000, 20000), rng.integers(0, 1000, 20000))
    snap = g.snapshot()
    before = g.io.analytics_read
    _ = snap.neighbors(5)
    cost_one = g.io.analytics_read - before
    assert cost_one < g.disk_bytes() / 50
    snap.release()


# ------------------------------------- the same stream through both packages
def _stream(seed, n_batches=6, batch=300):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_batches):
        src = rng.integers(0, V, batch)
        dst = rng.integers(0, V, batch)
        prop = rng.random(batch).astype(np.float32)
        ops.append(("insert", src, dst, prop))
        di = rng.integers(0, batch, batch // 10)
        ops.append(("delete", src[di], dst[di], None))
    return ops


def _drive(sys_, ops):
    for kind, src, dst, prop in ops:
        if kind == "insert":
            sys_.insert_edges(src, dst, prop)
        else:
            sys_.delete_edges(src, dst)


def _io(sys_):
    return dataclasses.astuple(sys_.io)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_baseline_equals_reference_on_one_stream(name, seed):
    ops = _stream(seed)
    got, want = SYSTEMS[name](_Port), SYSTEMS[name](ref_baselines)
    _drive(got, ops)
    _drive(want, ops)
    assert _io(got) == _io(want)
    for v in range(0, V, 3):
        a, b = got.neighbors(v), want.neighbors(v)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), v
    assert _io(got) == _io(want)
    for a, b in zip(got.snapshot_csr(), want.snapshot_csr()):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert _io(got) == _io(want)
    assert got.disk_bytes() == want.disk_bytes()


# ------------------------------------------------------------ CompactIndex
_sets = settings(max_examples=20, deadline=None,
                 suppress_health_check=list(HealthCheck))


def _same_index(got, want, vs):
    for v in vs:
        assert got.get_positions(v) == want.get_positions(v), v
    assert got.nbytes() == want.nbytes()
    assert got.interval == want.interval


@given(st.lists(st.tuples(st.integers(0, 500), st.integers(1, 4),
                          st.integers(0, 1 << 20), st.integers(0, 4096)),
                min_size=1, max_size=60))
@_sets
def test_compact_index_matches_dense_semantics_and_reference(entries):
    """The case of ``test_property.py``: the 2-slot + page-set index
    returns exactly what was set, and equals the reference's."""
    ci, ref = CompactIndex(vmax=512, interval=64), RefCompactIndex(
        vmax=512, interval=64)
    model = {}
    for (v, lvl, fid, off) in entries:
        ci.set_position(v, lvl, fid, off)
        ref.set_position(v, lvl, fid, off)
        model[(v, lvl)] = (fid, off)
    for (v, lvl), want in model.items():
        assert ci.get_positions(v).get(lvl) == want
    _same_index(ci, ref, range(512))


def test_compact_index_split_and_clear_equal_reference():
    """A fixed sequence that overflows one page (more than 4096 / 12 spilled
    entries in one interval, so ``_maybe_split`` halves the interval
    several times), then clears some positions: every row equal to the
    reference's, and ``nbytes()`` too."""
    rng = np.random.default_rng(3)
    ci, ref = CompactIndex(vmax=2048), RefCompactIndex(vmax=2048)
    for v in range(0, 2048, 2):
        for lvl in (4, 3, 2, 1):      # two inline, two spilled a vertex
            fid, off = int(rng.integers(0, 100)), int(rng.integers(0, 4096))
            ci.set_position(v, lvl, fid, off)
            ref.set_position(v, lvl, fid, off)
    assert ci.interval < 1024 and ci.interval == ref.interval
    for v in rng.integers(0, 2048, 300):
        lvl = int(rng.integers(1, 5))
        ci.clear_position(int(v), lvl)
        ref.clear_position(int(v), lvl)
    _same_index(ci, ref, range(2048))
