"""The stream generator: deterministic by seed, distinct edges, the 20:1
mix and the record counts."""
import numpy as np
import pytest
import torch

from lsmbench.data import make_stream, rmat_edges, update_stream

GRAPH = {"scale": 10, "n_edges": 6000, "a": 0.57, "b": 0.19, "c": 0.19}
STREAM = {"chunk": 512, "delete_ratio": 1 / 21}
CONFIG = {"graph": GRAPH, "stream": STREAM}
SEED = 2**32 + 5


def test_same_seed_same_stream_other_seed_other():
    a = make_stream(CONFIG, SEED, "cpu")
    b = make_stream(CONFIG, SEED, "cpu")
    c = make_stream(CONFIG, SEED + 1, "cpu")
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.prop, b.prop),
                 (a.ins, b.ins)):
        assert torch.equal(x, y)
    assert a.batches == b.batches
    assert not torch.equal(a.src[:a.n_inserts], c.src[:c.n_inserts])


def test_edges_distinct_in_range_with_kernel3_weights():
    src, dst, w = rmat_edges(GRAPH, SEED, "cpu")
    assert src.shape[0] == GRAPH["n_edges"]
    key = (src << 10) | dst
    assert torch.unique(key).shape[0] == key.shape[0]
    assert int(src.min()) >= 0 and int(src.max()) < 1 << GRAPH["scale"]
    assert int(dst.min()) >= 0 and int(dst.max()) < 1 << GRAPH["scale"]
    assert w.dtype == torch.float32
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0


def test_rmat_skew_survives_the_relabelling():
    # R-MAT concentrates edges on few sources whatever their labels: the
    # top 1 % of sources hold far more than 1 % of the edges.
    src, _, _ = rmat_edges(GRAPH, SEED, "cpu")
    deg = torch.bincount(src, minlength=1 << GRAPH["scale"]).sort(
        descending=True).values
    assert int(deg[:len(deg) // 100].sum()) > 0.05 * GRAPH["n_edges"]


def test_mix_is_twenty_to_one_and_counts_add_up():
    s = make_stream(CONFIG, SEED, "cpu")
    chunk, n = STREAM["chunk"], GRAPH["n_edges"]
    assert s.n_inserts == n
    assert s.n_records == s.n_inserts + s.n_deletes
    assert int(s.ins.sum()) == n
    runs = -(-n // chunk)
    picks = sum(int((min(off + chunk, n) - off) / 21)
                for off in range(chunk, n, chunk))
    assert s.n_deletes + s.picks_dropped == picks
    inserts = [b for b in s.batches if b[2]]
    deletes = [b for b in s.batches if not b[2]]
    assert len(inserts) == runs
    assert s.batches[0][2] and (len(s.batches) < 2 or s.batches[1][2])
    assert all(hi - lo <= chunk for lo, hi, _ in s.batches)
    assert sum(hi - lo for lo, hi, _ in deletes) == s.n_deletes
    # Batches tile the stream in order.
    assert s.batches[0][0] == 0 and s.batches[-1][1] == s.n_records
    assert all(a[1] == b[0] for a, b in zip(s.batches, s.batches[1:]))
    assert bool((s.prop[~s.ins] == 0).all())


def test_every_delete_follows_its_insert_once():
    s = make_stream(CONFIG, SEED, "cpu")
    key = ((s.src.long() << 32) | s.dst.long()).numpy()
    ins = s.ins.numpy()
    first_insert = {}
    deleted = set()
    for i, (k, is_ins) in enumerate(zip(key, ins)):
        if is_ins:
            assert k not in first_insert
            first_insert[k] = i
        else:
            assert k in first_insert and k not in deleted
            deleted.add(k)
    live = set(first_insert) - deleted
    live_any = set(s.live_any.tolist())
    assert live_any == {int(k) >> 32 for k in live} | {
        int(k) & 0xFFFFFFFF for k in live}
    assert set(s.live_in.tolist()) == {int(k) & 0xFFFFFFFF for k in live}


@pytest.mark.parametrize("ratio", [0.0, 1 / 21, 0.5])
def test_delete_ratio_sets_the_picks(ratio):
    src = torch.arange(2000)
    s = update_stream(src, src.flip(0), torch.rand(2000), {
        "chunk": 100, "delete_ratio": ratio}, SEED)
    assert s.n_deletes + s.picks_dropped == 19 * int(100 * ratio)
    assert np.all(np.diff([b[0] for b in s.batches]) > 0)


@pytest.mark.cuda
def test_generator_on_the_card_is_deterministic(cuda_device):
    a = make_stream(CONFIG, SEED, cuda_device)
    b = make_stream(CONFIG, SEED, cuda_device)
    assert torch.equal(a.src, b.src) and torch.equal(a.prop, b.prop)
    assert a.batches == b.batches

