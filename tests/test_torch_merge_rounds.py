"""The read spine's batched tournament (``kernels.merge.merge_pairs``) held
against the JAX package's pairwise tournament.

On the CPU ``tournament_merge`` lays the streams end to end and runs
``merge_pairs_plain`` over the round tables that the kernel also reads, so
these tests exercise the layout, the pairing (adjacent streams, the
straggler last) and stability (ties to A) that the kernel relies on.
Inputs are made with numpy from fixed seeds.  Tolerance: none — keys,
payload and pads are moved, never computed, so every column must be
byte-equal to ``repro.kernels.ops.tournament_merge`` (plain jnp backend)
and to a stable lexsort of the concatenation.  The JAX package keeps int32
with 64-bit types off, so an 8-byte payload column goes to it as its two
int32 halves.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import store as jax_store  # noqa: E402
from repro.core.csr import CSRRunArrays as JaxRunArrays  # noqa: E402
from repro.core.types import RunFile as JaxRunFile  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core import csr as pcsr  # noqa: E402
from repro_torch.core import store as port_store  # noqa: E402
from repro_torch.kernels import merge, ops  # noqa: E402

I32MAX = np.iinfo(np.int32).max


def _stream(rng, n, cap, kmax):
    """A (src, dst, ts)-sorted stream of n records in cap slots, all-MAX
    key pads, and payload: rid int32, marker bool, prop float32 (the
    spine's six columns), then uint8, int64 and float64 columns."""
    k = [rng.integers(0, kmax, n).astype(np.int32) for _ in range(3)]
    o = np.lexsort((k[2], k[1], k[0]))
    keys = []
    for x in k:
        p = np.full(cap, I32MAX, np.int32)
        p[:n] = x[o]
        keys.append(p)
    return keys + [rng.integers(-1, 40, cap).astype(np.int32),
                   rng.random(cap) < 0.3,
                   rng.random(cap).astype(np.float32),
                   rng.integers(0, 256, cap).astype(np.uint8),
                   rng.integers(-(1 << 62), 1 << 62, cap).astype(np.int64),
                   rng.random(cap)]


def _streams(k, seed):
    """Ragged capacities; streams with no record (all pads); equal keys
    across streams (a small key range, and records copied from one
    stream into another)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        cap = int(rng.integers(1, 700))
        n = 0 if i % 5 == 3 else int(rng.integers(0, cap + 1))
        out.append(_stream(rng, n, cap, 4 if i % 2 else 30))
    if k > 1:   # the same full records in streams 0 and 1
        a, b = out[0], out[1]
        m = min(len(a[0]), len(b[0]), 40)
        for j in range(len(a)):
            b[j][:m] = a[j][:m]
        o = np.lexsort((b[2], b[1], b[0]), axis=0)
        for j in range(len(b)):
            b[j] = b[j][o]
    return out


def _oracle(streams):
    """A stable lexsort of the concatenation: what the tournament gives."""
    cols = [np.concatenate([s[j] for s in streams])
            for j in range(len(streams[0]))]
    o = np.lexsort((cols[2], cols[1], cols[0]))
    return [c[o] for c in cols]


def _jax_cols(stream):
    """The stream as the JAX package takes it: an int64/float64 column as
    its two int32 halves, a uint8 column as int32."""
    out = []
    for c in stream:
        if c.dtype.itemsize == 8:
            out += list(np.ascontiguousarray(c).view(np.int32)
                        .reshape(-1, 2).T.copy())
        elif c.dtype == np.uint8:
            out.append(c.astype(np.int32))
        else:
            out.append(c)
    return out


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9, 17, 33])
def test_batched_tournament_matches_jax(k):
    streams = _streams(k, 500 + k)
    got = ops.tournament_merge(
        [tuple(torch.from_numpy(c) for c in s) for s in streams])
    got = [g.numpy() for g in got]
    assert [g.dtype for g in got] == [c.dtype for c in streams[0]]
    want = jops.tournament_merge(
        [tuple(jnp.asarray(c) for c in _jax_cols(s)) for s in streams])
    assert len(want) == len(_jax_cols(streams[0]))
    for g, w in zip(_jax_cols(got), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got, _oracle(streams)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("caps", [[0, 0], [0, 300], [300, 0, 0, 7],
                                  [5, 0, 2100, 0, 4097]])
def test_zero_capacity_streams_keep_their_place(caps):
    """Streams of no slot at all (the JAX package's tournament takes none)
    leave the pairing of the others as the tournament defines it; the
    result is the stable lexsort of the concatenation."""
    rng = np.random.default_rng(sum(caps))
    streams = [_stream(rng, int(rng.integers(0, c + 1)), c, 5)
               for c in caps]
    got = ops.tournament_merge(
        [tuple(torch.from_numpy(c) for c in s) for s in streams])
    for g, w in zip(got, _oracle(streams)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_merge_plan_tables_hand_written():
    """Five streams of capacities 3000, 10, 0, 2049 and 5, tiles of 2048
    output slots: three rounds, the straggler last in the first two."""
    plan = merge.merge_plan([3000, 10, 0, 2049, 5])
    assert merge.TILE == 2048
    assert plan.n == 5064 and plan.merges == 4 and len(plan.rounds) == 3
    want = [
        # (offset, na, nb, first tile) a pair; the tile -> pair table
        ([[0, 3000, 10, 0], [3010, 0, 2049, 2], [5059, 5, 0, 4]],
         [0, 0, 1, 1, 2]),
        ([[0, 3010, 2049, 0], [5059, 5, 0, 3]], [0, 0, 0, 1]),
        ([[0, 5059, 5, 0]], [0, 0, 0]),
    ]
    for rnd, (pairs, tiles) in zip(plan.rounds, want):
        assert rnd.pairs.dtype == np.int64
        assert rnd.tile_pair.dtype == np.int32
        np.testing.assert_array_equal(rnd.pairs, pairs)
        np.testing.assert_array_equal(rnd.tile_pair, tiles)
    one = merge.merge_plan([7])
    assert one.rounds == () and one.merges == 0 and one.n == 7
    with pytest.raises(ValueError):
        merge.merge_plan([])


def test_merge_pairs_cuda_rejects_cpu_tensors():
    cols = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(4))
    with pytest.raises(ValueError, match="CUDA"):
        merge.merge_pairs_cuda(cols, merge.merge_plan([2, 2]))


def _small_store():
    """SKILL.md's rehearsal shape: level_factor 2 and 256-edge segments
    give about a hundred L1 runs from a few tens of thousands of edges."""
    cfg = StoreConfig(vmax=1 << 12, mem_edges=1 << 10, seg_size=4,
                      n_segments=1 << 10, hash_slots=1 << 12,
                      ovf_cap=1 << 12, batch_cap=256, l0_run_limit=2,
                      seg_target_edges=256, level_factor=2, n_levels=5)
    g = LSMGraph(cfg, device="cpu")
    rng = np.random.default_rng(15)
    key = np.unique(rng.integers(0, 1 << 24, 26000))
    rng.shuffle(key)
    src, dst = key >> 12, key & 4095
    prop = rng.random(len(src)).astype(np.float32)
    for lo in range(0, len(src), 256):
        g.insert_edges(src[lo:lo + 256], dst[lo:lo + 256],
                       prop=prop[lo:lo + 256])
        if lo % 2560 == 0:
            g.delete_edges(src[lo:lo + 20], dst[lo:lo + 20])
    return g


def test_store_spine_matches_jax_pads_included():
    """A store with about a hundred L1 runs: its spine, built through the
    runs laid end to end (one searchsorted for every run's src), is
    byte-equal to the JAX package's ``_build_run_spine`` over the same
    runs, pads included; and the laid-out streams equal one
    ``csr.expand_src`` a run."""
    g = _small_store()
    runs = [(rf, -1) for rf in g.levels[0]] + [
        (rf, col) for col, lvl in enumerate(g.levels[1:]) for rf in lvl]
    assert len(g.levels[1]) >= 80 and len(g.levels[2]) >= 1
    cols, caps = port_store.lay_out_runs([rf for rf, _col in runs],
                                         rid_base=3)
    for (rf, _col), start, cap, rid in zip(
            runs, np.cumsum([0] + caps[:-1]), caps, range(3, 10**6)):
        a = rf.ensure_loaded()
        want = (pcsr.expand_src(a), a.dst, a.ts,
                torch.full((cap,), rid, dtype=torch.int32), a.marker, a.prop)
        for c, w in zip(cols, want):
            assert torch.equal(c[start:start + cap], w)
    pspine = port_store._build_run_spine(runs, "cpu")

    def jax_run(rf):
        a = convert.to_numpy(rf.ensure_loaded())
        arrays = JaxRunArrays(*(jnp.asarray(x) for x in a))
        return JaxRunFile(fid=rf.fid, level=rf.level, arrays=arrays,
                          min_vid=rf.min_vid, max_vid=rf.max_vid,
                          created_ts=rf.created_ts, nv=rf.nv, ne=rf.ne)

    jspine = jax_store._build_run_spine(
        [(jax_run(rf), col) for rf, col in runs])
    assert pspine.total == jspine.total
    for i, (jc, pc) in enumerate(zip(jspine.cols, pspine.cols)):
        jc = np.asarray(jc)
        assert jc.dtype == pc.numpy().dtype, i
        np.testing.assert_array_equal(jc, pc.numpy(), err_msg=f"col {i}")
