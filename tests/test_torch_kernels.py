"""The port's kernels (plain versions on the CPU) against the JAX package.

Inputs are made with numpy from fixed seeds and go through both packages:
the JAX side runs its Pallas kernels in interpret mode, as its own tests do,
and its pure references.  Tolerance: none for the presence matrix, the merge
permutation and segment-min (integers, bools, payload carried through, and
a min, which is exact in any order); segment-sum is held within rtol 1e-5 /
atol 1e-4, the tolerance of ``tests/test_kernels.py``, because its float32
additions run in another order in each implementation.  The
``cuda``-marked tests hold each hand-written kernel against its plain
version on the card and skip where there is none.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import filters as jfilters  # noqa: E402
from repro.kernels import merge as jmerge  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import filters  # noqa: E402
from repro_torch.core.store import _stack_presence  # noqa: E402
from repro_torch.kernels import merge, ops, presence  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import segment_reduce as segred  # noqa: E402

I32MAX = np.iinfo(np.int32).max


# ----------------------------------------------------------------- presence
def _presence_case(seed, with_filterless):
    rng = np.random.default_rng(seed)
    runs = [rng.integers(0, 1 << 28, n).astype(np.int64)
            for n in (1, 40, 700)]
    filts = [filters.from_vkeys(v) for v in runs]
    if with_filterless:
        filts.insert(1, None)
    queries = np.concatenate([runs[1][:20], runs[2][:30],
                              rng.integers(0, 1 << 28, 300)]).astype(np.int32)
    return filts, queries


def _padded(filts):
    """The JAX package's layout: rows padded to the widest filter, an
    all-ones row for a run without a filter (store._stack_presence)."""
    width = max(f.words.shape[0] for f in filts if f is not None)
    mat = np.zeros((len(filts), width), np.uint32)
    masks = np.empty(len(filts), np.uint32)
    for i, f in enumerate(filts):
        if f is None:
            mat[i] = 0xFFFFFFFF
            masks[i] = width * 32 - 1
        else:
            mat[i, :f.words.shape[0]] = f.words
            masks[i] = f.mbits - 1
    return mat, masks


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("with_filterless", [False, True])
def test_presence_matrix_matches_jax(seed, with_filterless):
    filts, queries = _presence_case(seed, with_filterless)
    mat, masks = _padded(filts)
    words, offs, fmasks = _stack_presence(
        [(SimpleNamespace(presence=f), 0) for f in filts], "cpu")
    got = ops.presence_matrix(words, offs, fmasks, torch.from_numpy(queries))
    assert got.dtype == torch.bool and got.shape == (len(filts),
                                                     len(queries))
    for use_pallas in (False, True):     # jnp reference, Pallas interpret
        want = np.asarray(jops.presence_matrix(
            jnp.asarray(mat), jnp.asarray(masks), jnp.asarray(queries),
            use_pallas=use_pallas))
        np.testing.assert_array_equal(got.numpy(), want)
    host = np.stack([np.ones(len(queries), bool) if f is None
                     else f.might_contain(queries) for f in filts])
    np.testing.assert_array_equal(got.numpy(), host)


def test_presence_words_match_jax_builder():
    rng = np.random.default_rng(4)
    for n in (0, 1, 17, 300, 5000):
        vk = np.unique(rng.integers(0, 1 << 31, n))
        np.testing.assert_array_equal(filters.build_words(vk),
                                      jfilters.build_words(vk))
        f = filters.from_vkeys(vk)
        dev = f.device_words("cpu")
        assert dev.dtype == torch.int32
        assert torch.equal(dev, convert.presence_words_to_torch(
            jfilters.build_words(vk), "cpu"))
        np.testing.assert_array_equal(convert.presence_words_to_numpy(dev),
                                      f.words)


def test_presence_wrapper_rejects_cpu_tensors():
    filts, queries = _presence_case(11, False)
    words, offs, masks = _stack_presence(
        [(SimpleNamespace(presence=f), 0) for f in filts], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        presence.presence_matrix_cuda(words, offs, masks,
                                      torch.from_numpy(queries))


# -------------------------------------------------------------------- merge
def _sorted_keys(rng, n, cap, kmax=40):
    k1 = rng.integers(0, kmax, n).astype(np.int32)
    k2 = rng.integers(0, kmax, n).astype(np.int32)
    k3 = rng.integers(0, 10000, n).astype(np.int32)
    o = np.lexsort((k3, k2, k1))
    out = []
    for k in (k1[o], k2[o], k3[o]):
        p = np.zeros(cap, np.int32)
        p[:n] = k
        out.append(p)
    return tuple(out)


@pytest.mark.parametrize("na,nb,cap,kmax", [
    (0, 5, 64, 40), (100, 200, 256, 40), (256, 256, 256, 40),
    (777, 333, 1024, 40), (500, 700, 1024, 2)])   # last: tie-heavy
def test_merge_perm_matches_jax(na, nb, cap, kmax):
    rng = np.random.default_rng(na * 7 + nb)
    a = _sorted_keys(rng, na, cap, kmax)
    b = _sorted_keys(rng, nb, cap, kmax)
    if kmax == 2:   # equal full keys across A and B: ties must go to A
        for k in range(3):
            b[k][:50] = a[k][:50]
        o = np.lexsort((b[2][:nb], b[1][:nb], b[0][:nb]))
        for k in range(3):
            b[k][:nb] = b[k][:nb][o]
    got = merge.merge_perm(tuple(torch.from_numpy(k) for k in a),
                           tuple(torch.from_numpy(k) for k in b),
                           na, nb).numpy()
    assert got.dtype == np.int32 and got.shape == (2 * cap,)
    want_pallas = np.asarray(jops.merge_perm(
        tuple(jnp.asarray(k) for k in a), tuple(jnp.asarray(k) for k in b),
        na, nb))
    np.testing.assert_array_equal(got, want_pallas)
    np.testing.assert_array_equal(got, jref.merge_perm_ref(a, b, na, nb))
    np.testing.assert_array_equal(got, ref.merge_perm_ref(a, b, na, nb))


@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_searchsorted_matches_jax(side):
    rng = np.random.default_rng(3)
    keys = _sorted_keys(rng, 300, 512, kmax=6)
    q = [rng.integers(0, 7, 200).astype(np.int32) for _ in range(2)] + [
        rng.integers(0, 10000, 200).astype(np.int32)]
    q[0][:50], q[1][:50], q[2][:50] = keys[0][:50], keys[1][:50], keys[2][:50]
    got = merge.lex_searchsorted(tuple(torch.from_numpy(k) for k in keys),
                                 *(torch.from_numpy(x) for x in q), 300,
                                 side=side)
    want = jmerge.lex_searchsorted(tuple(jnp.asarray(k) for k in keys),
                                   *(jnp.asarray(x) for x in q), 300,
                                   side=side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _stream(rng, n, pad):
    """A sorted (src, dst, ts, rid, marker, prop) stream with all-MAX pads."""
    k = _sorted_keys(rng, n, n + pad, kmax=12)
    cols = list(k)
    for c in cols:
        c[n:] = I32MAX
    rid = rng.integers(-1, 9, n + pad).astype(np.int32)
    marker = rng.random(n + pad) < 0.3
    prop = rng.random(n + pad).astype(np.float32)
    return tuple(cols) + (rid, marker, prop)


@pytest.mark.parametrize("k", range(1, 9))
def test_tournament_merge_matches_jax(k):
    rng = np.random.default_rng(100 + k)
    streams = [_stream(rng, int(rng.integers(0, 200)),
                       int(rng.integers(0, 20))) for _ in range(k)]
    got = ops.tournament_merge(
        [tuple(torch.from_numpy(c) for c in s) for s in streams])
    want = jops.tournament_merge(
        [tuple(jnp.asarray(c) for c in s) for s in streams])
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if k == 2:
        two = ops.merge_streams(*[tuple(torch.from_numpy(c) for c in s)
                                  for s in streams])
        for g, t in zip(got, two):
            assert torch.equal(g, t)


# ---------------------------------------------------------- segment reduce
SEG_TOL = dict(rtol=1e-5, atol=1e-4)   # tests/test_kernels.py's segsum tol


def _seg_case(seed, e, v, *, min_wt=False, n_out=None):
    rng = np.random.default_rng(seed)
    seg = np.sort(rng.integers(0, v, e)).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    if min_wt:
        wt = rng.uniform(0, 2, e).astype(np.float32)
    else:
        wt = rng.choice([1.0, -1.0, 0.0, 2.5], e).astype(np.float32)
    x = rng.normal(size=v).astype(np.float32)
    return dst, seg, wt, x, v if n_out is None else n_out


def _both(kind, dst, seg, wt, x, n_out):
    """(port's plain version, JAX Pallas in interpret mode, JAX ref)."""
    t = [torch.from_numpy(a) for a in (dst, seg, wt, x)]
    j = [jnp.asarray(a) for a in (dst, seg, wt, x)]
    port = getattr(ops, f"gather_{kind}")(*t, n_out=n_out).numpy()
    pallas = np.asarray(getattr(jops, f"gather_{kind}")(*j, n_out=n_out))
    jref_ = np.asarray(getattr(jref, f"gather_{kind}_ref")(*j, n_out))
    return port, pallas, jref_


@pytest.mark.parametrize("e,v", [(64, 8), (512, 64), (1000, 300),
                                 (513, 7), (2048, 2048)])
def test_gather_segsum_matches_jax(e, v):
    case = _seg_case(e + v, e, v)
    port, pallas, jref_ = _both("segsum", *case)
    assert port.dtype == np.float32 and port.shape == (v,)
    np.testing.assert_allclose(port, pallas, **SEG_TOL)
    np.testing.assert_allclose(port, jref_, **SEG_TOL)


@pytest.mark.parametrize("e,v", [(100, 20), (777, 100), (513, 7)])
def test_gather_segmin_matches_jax(e, v):
    port, pallas, jref_ = _both("segmin", *_seg_case(e + v, e, v,
                                                     min_wt=True))
    assert port.dtype == np.float32 and port.shape == (v,)
    np.testing.assert_array_equal(port, pallas)
    np.testing.assert_array_equal(port, jref_)


def test_segsum_tombstone_annihilation():
    """wt=-1 rows cancel wt=+1 rows of the same (seg, dst): the multilevel
    analytics' core identity."""
    rng = np.random.default_rng(5)
    seg = np.array([0, 0, 1, 1], np.int32)
    dst = np.array([5, 5, 6, 7], np.int32)
    wt = np.array([1.0, -1.0, 1.0, 1.0], np.float32)
    x = rng.normal(size=10).astype(np.float32)
    port, pallas, jref_ = _both("segsum", dst, seg, wt, x, 2)
    assert port[0] == 0.0 and abs(port[1] - (x[6] + x[7])) < 1e-5
    np.testing.assert_allclose(port, pallas, **SEG_TOL)
    np.testing.assert_allclose(port, jref_, **SEG_TOL)


@pytest.mark.parametrize("kind", ["segsum", "segmin"])
def test_segment_reduce_edge_cases_match_jax(kind):
    """No edges at all; segments >= n_out (dropped) and empty segments."""
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.float32), np.ones(5, np.float32), 4)
    ragged = (np.arange(8, dtype=np.int32),
              np.array([0, 1, 1, 3, 5, 6, 6, 9], np.int32),
              np.linspace(0.5, 2.0, 8).astype(np.float32),
              np.arange(1, 9, dtype=np.float32), 5)
    for case in (empty, ragged):
        port, pallas, jref_ = _both(kind, *case)
        np.testing.assert_array_equal(port, pallas)
        np.testing.assert_array_equal(port, jref_)
    assert np.array_equal(_both(kind, *empty)[0],
                          np.full(4, 0.0 if kind == "segsum" else 3.0e38,
                                  np.float32))


@pytest.mark.parametrize("kind", ["segsum", "segmin"])
def test_segment_reduce_clips_like_reference(kind):
    """Out-of-range dst clip to [0, len(x)-1]; negative seg_id count as
    segment 0 (the reference's ``ref.py``)."""
    dst = np.array([-3, 0, 9, 40, 2, 2], np.int32)
    seg = np.array([-2, -1, 0, 1, 1, 7], np.int32)
    wt = np.array([1.0, 2.0, 0.5, 1.5, 1.0, 1.0], np.float32)
    x = np.arange(1, 11, dtype=np.float32)
    port, _, jref_ = _both(kind, dst, seg, wt, x, 3)
    np.testing.assert_array_equal(port, jref_)


def test_segment_wrappers_reject_cpu_tensors():
    dst, seg, wt, x, n = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in _seg_case(1, 50, 10))
    for fn in (segred.gather_segsum_cuda, segred.gather_segmin_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(dst, seg, wt, x, n)


def test_launch_counters_ignore_plain_calls():
    ops.reset_launches()
    a = tuple(torch.arange(8, dtype=torch.int32) for _ in range(3))
    ops.merge_perm(a, a, 8, 8)
    dst, seg, wt, x, n = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                          else a for a in _seg_case(1, 50, 10))
    ops.gather_segsum(dst, seg, wt, x, n_out=n)
    ops.gather_segmin(dst, seg, wt, x, n_out=n, use_pallas=False)
    assert ops.launch_counts() == {"presence_matrix": 0, "merge_perm": 0,
                                   "gather_segsum": 0, "gather_segmin": 0}


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: each hand-written kernel against its plain version,
    and each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    ops.reset_launches()
    filts, queries = _presence_case(11, True)
    words, offs, masks = _stack_presence(
        [(SimpleNamespace(presence=f), 0) for f in filts], dev)
    q = torch.from_numpy(queries).to(dev)
    assert torch.equal(presence.presence_matrix_cuda(words, offs, masks, q),
                       presence.presence_matrix_ref(words, offs, masks, q))
    rng = np.random.default_rng(1)
    a = tuple(torch.from_numpy(k).to(dev)
              for k in _sorted_keys(rng, 5000, 6000, 3))
    b = tuple(torch.from_numpy(k).to(dev)
              for k in _sorted_keys(rng, 3000, 3000, 3))
    assert torch.equal(merge.merge_perm_cuda(a, b, 5000, 3000),
                       merge.merge_perm_plain(a, b, 5000, 3000))
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"presence_matrix": 1, "merge_perm": 1,
                                   "gather_segsum": 0, "gather_segmin": 0}
