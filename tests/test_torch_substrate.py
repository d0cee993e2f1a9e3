"""The port's training substrate against the JAX package's: the token
pipeline (``data/pipeline.py``), checkpoints (``checkpoint/``), the
fault-tolerant loop and step monitor (``runtime/``), the training entry point
and the ported ``examples/train_lm.py``.

* Pipeline batches byte-equal to the reference's, with resume and host
  sharding.
* Checkpoint directories byte-equal to the reference's for the states of
  ``tests/test_substrate.py`` (``manifest.json`` and every
  ``shard_k.npz``; both saves under one clock, since a zip member records
  its write time), with gc and a stale ``.tmp``.
* bfloat16: the reference's ``restore`` returns a bfloat16 leaf as raw
  ``|V2`` bytes (its fault 9, ROADMAP); the port writes the same files and
  restores bfloat16 from its own directory and from the reference's.
* Fault recovery bit-equal: the reference's toy loop, and the real train
  step on reduced qwen2-1.5b (bfloat16 weights) on the CPU.
"""
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as RefManager  # noqa: E402,E501
from repro.data.pipeline import PipelineState as RefState  # noqa: E402
from repro.data.pipeline import TokenPipeline as RefPipeline  # noqa: E402
from repro.runtime import fault as ref_fault  # noqa: E402
from repro.runtime.monitor import StepMonitor as RefMonitor  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, reshard_state  # noqa: E402,E501
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.data.pipeline import PipelineState, TokenPipeline  # noqa: E402,E501
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.optim import AdamWState, adamw_init  # noqa: E402
from repro_torch.runtime import StepMonitor  # noqa: E402
from repro_torch.runtime.fault import (FailureInjector,  # noqa: E402
                                       FaultTolerantLoop)

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------- data
def test_pipeline_batches_byte_equal_with_resume():
    ref = RefPipeline(vocab=1000, seq_len=32, global_batch=4, seed=7)
    port = TokenPipeline(vocab=1000, seq_len=32, global_batch=4, seed=7)
    for _ in range(3):
        rb, pb = ref.next_batch(), port.next_batch()
        for k in ("tokens", "targets"):
            assert pb[k].dtype == rb[k].dtype
            assert pb[k].tobytes() == rb[k].tobytes()
    assert port.state.to_json() == ref.state.to_json() == \
        {"seed": 7, "next_step": 3}
    resumed = TokenPipeline(vocab=1000, seq_len=32, global_batch=4, seed=7,
                            state=PipelineState.from_json(
                                {"seed": 7, "next_step": 1}))
    ref_resumed = RefPipeline(vocab=1000, seq_len=32, global_batch=4,
                              seed=7, state=RefState(seed=7, next_step=1))
    assert resumed.next_batch()["tokens"].tobytes() == \
        ref_resumed.next_batch()["tokens"].tobytes()


def test_pipeline_host_sharding_byte_equal():
    full = RefPipeline(vocab=500, seq_len=16, global_batch=8, seed=3)
    b_full = full.next_batch()["tokens"]
    parts = []
    for h in range(4):
        p = TokenPipeline(vocab=500, seq_len=16, global_batch=8, host_id=h,
                          n_hosts=4, seed=3)
        r = RefPipeline(vocab=500, seq_len=16, global_batch=8, host_id=h,
                        n_hosts=4, seed=3)
        got = p.next_batch()["tokens"]
        assert got.tobytes() == r.next_batch()["tokens"].tobytes()
        parts.append(got)
    assert np.concatenate(parts).tobytes() == b_full.tobytes()


# --------------------------------------------------------------- checkpoint
def _tree_files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _dirs(root: Path):
    return sorted(p.name for p in root.iterdir())


@mock.patch("time.time", return_value=1.7e9)
def test_checkpoint_files_byte_equal(_clock, tmp_path):
    """``tests/test_substrate.py``'s states, saved by both packages: the
    same directories and bytes; restore (a given step, and the latest)
    gives the same arrays and extra; gc keeps the newest two; a stale
    ``.tmp`` does not shadow a commit."""
    state = {"a": np.arange(10, dtype=np.float32),
             "nested": {"b": np.ones((3, 3), np.int32)},
             "list": [np.zeros(2, np.float32), (np.int32(5),
                                                np.float32(0.5))]}
    state2 = {"a": state["a"] * 2, "nested": {"b": state["nested"]["b"] + 1},
              "list": [np.ones(2, np.float32), (np.int32(6),
                                                np.float32(1.5))]}
    extra = {"pipeline": {"seed": 1, "next_step": 10}}
    managers = {}
    for name, cls in (("ref", RefManager), ("port", CheckpointManager)):
        cm = managers[name] = cls(str(tmp_path / name), keep=2)
        cm.save(10, state)
        cm.save(20, state2)
        cm.save(30, state, extra=extra, shards=3)
        cm.save(40, {"x": np.asarray([4])}, shards=1)
    ref, port = _tree_files(tmp_path / "ref"), _tree_files(tmp_path / "port")
    assert _dirs(tmp_path / "port") == _dirs(tmp_path / "ref") == \
        ["step_30", "step_40"]
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k] == ref[k], k
    for name in ("ref", "port"):
        os.makedirs(tmp_path / name / "step_50.tmp")
        assert managers[name].latest_step() == 40
    got, extra_p = managers["port"].restore(state, step=30)
    want, extra_r = managers["ref"].restore(state, step=30)
    assert extra_p == extra_r == extra
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    latest, _ = managers["port"].restore({"x": np.asarray([0])})
    np.testing.assert_array_equal(latest["x"], [4])
    with pytest.raises(FileNotFoundError):
        managers["port"].restore(state, step=10)


@mock.patch("time.time", return_value=1.7e9)
def test_bf16_restore_fixes_reference_fault9(_clock, tmp_path):
    """The reference writes a bfloat16 leaf's raw bits and records
    ``bfloat16``, but restores ``|V2`` void bytes, which JAX cannot take
    (``launch/train.py --fail-at`` crashes at its first restore).  The
    port writes the same bytes and restores bfloat16."""
    rng = np.random.default_rng(0)
    w32 = rng.normal(0, 1, (5, 7)).astype(np.float32)
    jstate = {"w": jnp.asarray(w32, jnp.bfloat16), "n": np.int32(3)}
    tstate = {"w": torch.from_numpy(w32).to(torch.bfloat16),
              "n": np.int32(3)}
    RefManager(str(tmp_path / "ref")).save(1, jax.tree.map(np.asarray,
                                                            jstate))
    CheckpointManager(str(tmp_path / "port")).save(1, tstate)
    ref_files = _tree_files(tmp_path / "ref")
    assert _tree_files(tmp_path / "port") == ref_files
    manifest = json.loads(ref_files["step_1/manifest.json"])
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    # The reference's fault: raw void bytes come back.
    got_ref, _ = RefManager(str(tmp_path / "ref")).restore(jstate)
    assert got_ref["w"].dtype == np.dtype("V2")
    want_bits = tstate["w"].view(torch.int16)
    for d in ("ref", "port"):
        # Into a tensor template, in place: bfloat16, the same bits.
        tmpl = {"w": torch.zeros(5, 7, dtype=torch.bfloat16),
                "n": np.int32(0)}
        got, _ = CheckpointManager(str(tmp_path / d)).restore(tmpl)
        assert got["w"] is tmpl["w"] and got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), want_bits)
        assert int(got["n"]) == 3
        # Into a NumPy template: a bfloat16 CPU tensor.
        got, _ = CheckpointManager(str(tmp_path / d)).restore(
            {"w": np.zeros((5, 7), np.float32), "n": np.int32(0)})
        assert got["w"].dtype == torch.bfloat16
        assert torch.equal(got["w"].view(torch.int16), want_bits)


def test_model_and_adamw_state_roundtrip(tmp_path):
    """A ``Model`` and an ``AdamWState`` flatten by parameter name and
    load back in place, bit for bit; ``save_async`` snapshots before the
    caller writes again."""
    cfg = reduced_config("deepseek-v2-236b")
    model = Model(cfg, device="cpu", seed=1)   # bfloat16, a float32 router
    opt = adamw_init(model)
    opt.m["embed"].normal_()
    opt = opt._replace(step=torch.tensor(7, dtype=torch.int32))
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    cm = CheckpointManager(str(tmp_path))
    cm.save_async(7, (model, opt), extra={"k": 1})
    with torch.no_grad():
        model.embed.add_(1.0)     # after the snapshot: not saved
    cm.wait()
    manifest = json.loads((tmp_path / "step_7" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["0/embed"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["0/blocks/1/moe/router/w"]["dtype"] == \
        "float32"
    assert manifest["leaves"]["1/.step"] == {"shape": [], "dtype": "int32",
                                             "shard": manifest["leaves"][
                                                 "1/.step"]["shard"]}
    assert "1/.m/embed" in manifest["leaves"]
    fresh = Model(cfg, device="cpu", seed=2)
    tmpl = (fresh, adamw_init(fresh))
    (got_model, got_opt), extra = cm.restore(tmpl)
    assert extra == {"k": 1} and got_model is fresh
    assert isinstance(got_opt, AdamWState) and int(got_opt.step) == 7
    for n, q in fresh.named_parameters():
        assert saved[n].dtype == q.dtype and torch.equal(saved[n], q), n
    assert torch.equal(got_opt.m["embed"], opt.m["embed"])


def test_reshard_state_roundtrip():
    state = {"w": np.arange(8, dtype=np.float32),
             "t": (np.int32(3), [np.ones((2, 2), np.int32)])}
    out = reshard_state(state, "cpu")
    assert isinstance(out["w"], torch.Tensor)
    np.testing.assert_array_equal(out["w"].numpy(), state["w"])
    assert isinstance(out["t"], tuple) and int(out["t"][0]) == 3
    np.testing.assert_array_equal(out["t"][1][0].numpy(), state["t"][1][0])

    class Mesh:   # a ShardMesh places on its rank's device
        device = torch.device("cpu")
    back = reshard_state(out, Mesh())
    assert back["w"].device.type == "cpu"
    np.testing.assert_array_equal(back["w"].numpy(), state["w"])


# -------------------------------------------------------------------- fault
def _toy_loop(mod, cm_cls, pipe_cls, path, fail_at=()):
    pipeline = pipe_cls(vocab=100, seq_len=8, global_batch=2, seed=0)

    def step_fn(state, batch):
        w = state["w"] + np.float32(batch["tokens"].mean())
        return {"w": w}, float(w)

    return mod.FaultTolerantLoop(
        step_fn=step_fn, init_state={"w": np.float32(0)}, pipeline=pipeline,
        ckpt=cm_cls(str(path), keep=5), ckpt_every=5,
        injector=mod.FailureInjector(fail_at))


def test_fault_recovery_toy_matches_reference(tmp_path):
    from repro_torch.runtime import fault as port_fault
    runs = {}
    for name, mod, cm, pipe in (
            ("ref", ref_fault, RefManager, RefPipeline),
            ("port", port_fault, CheckpointManager, TokenPipeline)):
        clean = _toy_loop(mod, cm, pipe, tmp_path / name / "clean")
        clean.run(20)
        faulty = _toy_loop(mod, cm, pipe, tmp_path / name / "faulty",
                           fail_at=(7, 13))
        faulty.run(20)
        assert faulty.restarts == 2
        for s in range(15, 20):
            assert clean.metrics[s] == faulty.metrics[s]
        runs[name] = (clean.metrics, faulty.metrics, faulty.stragglers)
    assert runs["port"][:2] == runs["ref"][:2]


def test_fault_recovery_real_step_bit_equal(tmp_path):
    """Reduced qwen2-1.5b, bfloat16 weights, the real train step: a run
    with failures at 5 and 9 (checkpoints every 4) against an
    uninterrupted one: the losses from step 8 and the final checkpoint's
    files byte-equal, every restored leaf bfloat16 where it was."""
    cfg = reduced_config("qwen2-1.5b")

    def run(fail_at, d):
        model = Model(cfg, device="cpu", seed=0)
        step_fn = train.make_train_step(cfg, n_micro=2)

        def loop_step(state, batch):
            m, o = state
            m, o, loss = step_fn(m, o, train.to_device(batch, "cpu"))
            return (m, o), float(loss)

        loop = FaultTolerantLoop(
            step_fn=loop_step, init_state=(model, adamw_init(model)),
            pipeline=TokenPipeline(vocab=cfg.vocab, seq_len=32,
                                   global_batch=4, seed=0),
            ckpt=CheckpointManager(str(d)), ckpt_every=4,
            injector=FailureInjector(fail_at))
        loop.run(12)
        return loop

    clean = run((), tmp_path / "clean")
    faulty = run((5, 9), tmp_path / "faulty")
    assert faulty.restarts == 2 and clean.restarts == 0
    for s in range(8, 12):
        assert clean.metrics[s] == faulty.metrics[s], s
    assert all(np.isfinite(v) for v in faulty.metrics.values())
    model, _ = faulty.state
    assert model.embed.dtype == torch.bfloat16
    # The loops' final checkpoints: the manifests byte-equal; the states
    # saved again under one clock (a zip member records its write time),
    # every file byte-equal.
    assert (tmp_path / "clean" / "step_12" / "manifest.json").read_bytes() \
        == (tmp_path / "faulty" / "step_12" / "manifest.json").read_bytes()
    with mock.patch("time.time", return_value=1.7e9):
        for loop, d in ((clean, "c"), (faulty, "f")):
            CheckpointManager(str(tmp_path / d)).save(12, loop.state)
    assert _tree_files(tmp_path / "c") == _tree_files(tmp_path / "f")


# ------------------------------------------------------------------ monitor
def test_step_monitor_summary_matches_reference():
    ref, port = RefMonitor(), StepMonitor()
    times = [0.3, 0.1, 0.2, 0.5, 0.4, 0.05, 0.25]
    ref.times, port.times = list(times), list(times)
    assert port.summary() == ref.summary()
    assert StepMonitor().summary() == RefMonitor().summary() == {}
    port.start()
    time.sleep(0.01)
    assert port.stop() >= 0.01 and len(port.times) == len(times) + 1


# ------------------------------------------------------------ entry points
def test_train_main_on_cpu(capsys):
    loop = train.main(["--reduced", "--device", "cpu", "--steps", "6",
                       "--fail-at", "3", "--ckpt-every", "2", "--batch",
                       "2", "--seq", "32"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"arch=qwen2-1\.5b params=\d+\.\dM active=\d+\.\dM",
                        out[0]), out
    assert re.fullmatch(r"done: 6 steps in \d+\.\ds; loss \d+\.\d{3} -> "
                        r"\d+\.\d{3}; restarts=1 stragglers=\d+", out[1]), out
    assert out[2].startswith("timing: {'mean_s'")
    assert loop.restarts == 1 and sorted(loop.metrics) == list(range(6))


def test_train_main_needs_a_card_without_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--reduced", "--steps", "1"],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode != 0 and "no CUDA device" in out.stderr


def test_train_lm_example_exact_replay(capsys):
    drift = train_lm.main(["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert drift == 0.0
    assert "(restarts=2)" in out[1]
    assert out[2] == "post-recovery trajectory drift: 0.00e+00 (exact replay)"
