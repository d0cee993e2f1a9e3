"""The MemGraph insert's claim step (``kernels/hash_claim.py``,
``core/memgraph.py``), with no JAX import, so that the file runs where only
PyTorch is installed:

    python -m pytest -q tests/test_torch_hash_claim.py

On the CPU: the plain version's fixed-shape dedup equals
``torch.unique(sorted=True, return_inverse=True)`` padded with
``INVALID_VID``, and CPU keys run the plain version without building or
loading a kernel.  On the card (``cuda`` marker): ``csrc/hash_claim.cu``
equals its plain version slot for slot (unique keys and inverse, tables,
row count, rows, new flags, ok and the round count) on an R-MAT
chunk into a table loaded to 0.6, on more keys than the grid has threads,
on a table too small for its keys, on padding alone and on one repeated
key; the insert equals the CPU's on the small table of
``tests/test_torch_core.py::test_memgraph_insert_flush_scan``; and the
claim step of a full-size insert reads nothing to the host.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import LSMGraph, StoreConfig  # noqa: E402
from repro_torch.core import memgraph  # noqa: E402
from repro_torch.core.types import INVALID_VID, EdgeBatch, scalar  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import hash_claim  # noqa: E402

I32 = torch.int32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rmat_sources(rng, n, scale=22):
    """Sources of Graph500 R-MAT edges (A/B/C 0.57/0.19/0.19: each bit of a
    source is 1 with probability C + D = 0.24), the ids relabelled by a
    random permutation as the specification asks."""
    bits = rng.random((n, scale)) < 0.24
    src = (bits.astype(np.int64) << np.arange(scale)).sum(1)
    return rng.permutation(1 << scale)[src].astype(np.int32)


def _padded(keys, cap):
    out = np.full(cap, INVALID_VID, np.int32)
    out[:len(keys)] = keys
    return torch.from_numpy(out)


# ---------------------------------------------------------------- the CPU
DEDUP_CASES = {
    "padding-and-repeats": (0, 4096, 3000, 500),
    "no-padding": (1, 1024, 1024, 40),
    "wide-ids": (2, 2048, 1500, 1 << 31),
    "one-key": (3, 256, 200, 1),
    "all-padding": (4, 64, 0, 10),
}


@pytest.mark.parametrize("case", sorted(DEDUP_CASES))
def test_unique_padded_equals_torch_unique(case):
    seed, cap, n, hi = DEDUP_CASES[case]
    rng = np.random.default_rng(seed)
    src = rng.integers(-(hi // 4), hi, n, dtype=np.int64).astype(np.int32)
    keys = _padded(src, cap)
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    want = torch.cat([uniq, torch.full((cap - uniq.shape[0],), INVALID_VID,
                                       dtype=I32)])
    ukeys, got_inv = hash_claim.unique_padded(keys)
    assert ukeys.dtype == I32 and got_inv.dtype == torch.int64
    assert torch.equal(ukeys, want)
    assert torch.equal(got_inv, inv)


def test_cpu_keys_run_the_plain_version_and_build_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CPU insert reached the kernel build")

    for name in ("load", "bind", "build_all", "run_on"):
        monkeypatch.setattr(_build, name, refuse)
    monkeypatch.setattr(hash_claim, "claim_rows_cuda", refuse)
    cfg = StoreConfig(vmax=1 << 12, mem_edges=1 << 10, seg_size=4,
                      n_segments=1 << 10, hash_slots=1 << 10,
                      ovf_cap=1 << 12, batch_cap=256)
    rng = np.random.default_rng(7)
    mg = memgraph.empty_memgraph(cfg, "cpu")
    src = _padded(rng.integers(0, 600, 200).astype(np.int32), 256)
    got = hash_claim.claim_rows(mg.htab_key, mg.htab_row, mg.n_rows, src)
    ukeys, inv = hash_claim.unique_padded(src)
    want = hash_claim.find_or_insert_rows_ref(mg.htab_key, mg.htab_row,
                                              mg.n_rows, ukeys)
    for g, w in zip(got, (ukeys, inv, *want[:-1])):
        assert torch.equal(g, w)
    assert got[-1].dtype == I32 and got[-1].dim() == 0
    assert int(got[-1]) == want[-1] >= 1
    z = torch.zeros(256, dtype=I32)
    batch = EdgeBatch(src=src, dst=z, ts=z, prop=z.float(),
                      marker=z.bool(), n=scalar(200, "cpu"))
    new, ok, rounds = memgraph.insert_batch_counted(mg, batch)
    assert bool(ok) and int(rounds) == want[-1]
    assert int(new.n_rows) == int(want[2])


# --------------------------------------------------------------- the card
def _claim_both(htab_key, htab_row, n_rows, keys):
    """The kernel's outputs and the plain version's on the same CUDA
    tensors, asserted equal slot for slot: (ukeys, inv, htab_key, htab_row,
    n_rows, row, is_new, ok, rounds)."""
    before = hash_claim.claim_rows_cuda.launches
    got = hash_claim.claim_rows(htab_key, htab_row, n_rows, keys)
    assert hash_claim.claim_rows_cuda.launches == before + 1
    want = hash_claim.claim_rows_ref(htab_key, htab_row, n_rows, keys)
    torch.cuda.synchronize()
    names = ("ukeys", "inv", "htab_key", "htab_row", "n_rows", "row",
             "is_new", "ok", "rounds")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    return got


def _loaded_table(dev, hcap, n_keys, seed):
    """A table holding n_keys distinct vertex ids of a scale-22 graph,
    inserted by the plain version in chunks of 65,536."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 22, n_keys, replace=False).astype(np.int32)
    htab_key = torch.full((hcap,), INVALID_VID, dtype=I32, device=dev)
    htab_row = torch.zeros(hcap, dtype=I32, device=dev)
    n_rows = scalar(0, dev)
    for off in range(0, n_keys, 1 << 16):
        chunk = torch.from_numpy(np.sort(keys[off:off + (1 << 16)])).to(dev)
        (htab_key, htab_row, n_rows, _r, _n, ok,
         _rounds) = hash_claim.find_or_insert_rows_ref(htab_key, htab_row,
                                                       n_rows, chunk)
        assert bool(ok)
    return htab_key, htab_row, n_rows


@pytest.mark.cuda
def test_cuda_hash_claim_rmat_chunk_into_a_loaded_table():
    dev = _card()
    hcap = 1 << 21
    htab_key, htab_row, n_rows = _loaded_table(dev, hcap, int(0.6 * hcap), 1)
    rng = np.random.default_rng(2)
    src = torch.from_numpy(_rmat_sources(rng, 1 << 16)).to(dev)
    got = _claim_both(htab_key, htab_row, n_rows, src)
    assert bool(got[7]) and int(got[8]) >= 2
    assert 0 < int(got[6].sum()) < int((got[0] != INVALID_VID).sum())


@pytest.mark.cuda
def test_cuda_hash_claim_more_keys_than_the_grid_has_threads():
    dev = _card()
    hcap = 1 << 21
    rng = np.random.default_rng(3)
    keys = rng.choice(1 << 22, 1 << 19, replace=False).astype(np.int32)
    htab_key, htab_row, n_rows = _loaded_table(dev, hcap, 1 << 17, 4)
    got = _claim_both(htab_key, htab_row, n_rows,
                      torch.from_numpy(keys).to(dev))
    assert bool(got[7]) and int(got[4]) == int(n_rows) + int(got[6].sum())


@pytest.mark.cuda
def test_cuda_hash_claim_table_too_small():
    dev = _card()
    ukeys = torch.arange(0, 64, 2, dtype=I32, device=dev)   # 32 keys
    got = _claim_both(torch.full((16,), INVALID_VID, dtype=I32, device=dev),
                      torch.zeros(16, dtype=I32, device=dev), scalar(0, dev),
                      ukeys)
    assert not bool(got[7]) and int(got[8]) == hash_claim.MAX_PROBE_ROUNDS


@pytest.mark.cuda
@pytest.mark.parametrize("keys", ["all-padding", "one-repeated-key"])
def test_cuda_hash_claim_padding_and_one_key(keys):
    dev = _card()
    cap = 4096
    src = torch.full((cap,), INVALID_VID if keys == "all-padding" else 12345,
                     dtype=I32, device=dev)
    htab_key, htab_row, n_rows = _loaded_table(dev, 1 << 12, 1000, 5)
    got = _claim_both(htab_key, htab_row, n_rows, src)
    assert int((got[0] != INVALID_VID).sum()) == (keys != "all-padding")
    assert int(got[1].max()) == 0
    assert (int(got[8]) == 0) == (keys == "all-padding")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["memgraph", "array_only"])
def test_cuda_insert_matches_cpu_on_a_small_table(mode):
    # The configuration of test_memgraph_insert_flush_scan: hash_slots
    # barely above the row count, long probe chains and lost claims.
    dev = _card()
    cfg = StoreConfig(vmax=300, mem_edges=1 << 10, seg_size=4,
                      n_segments=256, hash_slots=256, ovf_cap=1 << 12,
                      batch_cap=64, memcache_mode=mode)
    rng = np.random.default_rng(5)
    cpu, card = (memgraph.empty_memgraph(cfg, "cpu"),
                 memgraph.empty_memgraph(cfg, dev))
    bc = cfg.batch_cap
    for _ in range(4):
        n = int(rng.integers(1, bc + 1))
        src = rng.integers(0, cfg.vmax, n).astype(np.int32)
        src[: n // 4] = rng.integers(0, 4, n // 4)
        cols = [src, rng.integers(0, cfg.vmax, n).astype(np.int32),
                rng.permutation(1 << 20)[:n].astype(np.int32),
                rng.random(n).astype(np.float32), rng.random(n) < 0.2]
        padded = []
        for a in cols:
            out = np.zeros(bc, a.dtype)
            out[:n] = a
            padded.append(torch.from_numpy(out))
        batch = EdgeBatch(*padded, n=scalar(n, "cpu"))
        cpu, cok, crounds = memgraph.insert_batch_counted(cpu, batch,
                                                          mode=mode)
        card, gok, grounds = memgraph.insert_batch_counted(
            card, EdgeBatch(*(t.to(dev) for t in batch)), mode=mode)
        assert (bool(gok), int(grounds)) == (bool(cok), int(crounds))
        for f in cpu._fields:
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert int(cpu.n_rows) > 0


@pytest.mark.cuda
def test_cuda_claim_step_reads_nothing_to_the_host():
    dev = _card()
    hcap, bc = 1 << 21, 1 << 16
    htab_key, htab_row, n_rows = _loaded_table(dev, hcap, int(0.6 * hcap), 6)
    rng = np.random.default_rng(7)
    src = torch.from_numpy(_rmat_sources(rng, bc)).to(dev)
    n = scalar(bc - 100, dev)

    def claim():
        pos = torch.arange(bc, dtype=I32, device=dev)
        srcv = torch.where(pos < n, src, INVALID_VID).to(I32)
        return hash_claim.claim_rows(htab_key, htab_row, n_rows, srcv)

    want = claim()   # builds and loads the kernel
    torch.cuda.synchronize()
    before = hash_claim.claim_rows_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = claim()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert hash_claim.claim_rows_cuda.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[7])

    # A store's insert at the benchmark's MemGraph (lsmbench/configs/
    # g500-s22.json): one launch a chunk, the rounds observed at the wait.
    cfg = StoreConfig(vmax=1 << 22, mem_edges=1 << 21, seg_size=8,
                      n_segments=1 << 20, hash_slots=hcap, ovf_cap=1 << 21,
                      batch_cap=bc)
    g = LSMGraph(cfg, device=dev)
    hist = obs.REGISTRY.histogram("store_apply_claim_rounds", lo=1)
    launches, chunks, rounds = (hash_claim.claim_rows_cuda.launches,
                                hist.count, hist.sum)
    edges = 3 * bc
    g.insert_edges(_rmat_sources(rng, edges), rng.integers(0, 1 << 22, edges))
    g.close()
    assert hash_claim.claim_rows_cuda.launches == launches + 3
    assert hist.count == chunks + 3 and hist.sum - rounds >= 3
