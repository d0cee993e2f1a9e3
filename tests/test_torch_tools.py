"""The port's kernel timing scripts run on the CPU as far as they can: the
text edits of ``tools/segment_variants.py`` still find their anchors in the
checkout's ``csrc/segment_reduce.cu``, and every script refuses to run
without a card."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

import probe_bench  # noqa: E402
import segment_bench  # noqa: E402
import segment_variants  # noqa: E402

CHECKOUT = (ROOT / "src" / "repro_torch" / "csrc" /
            "segment_reduce.cu").read_text()


@pytest.mark.parametrize("ptx", sorted(segment_variants.PTX.values()))
def test_load_edits_find_the_checkouts_loads(ptx):
    """Each stream edit puts the helpers in and replaces all three stream
    loads of the single-run kernel, and nothing of the multi-run one."""
    out = segment_variants.with_loads(CHECKOUT, ptx)
    assert out.count(f'asm("{ptx}.') == 2
    assert out.count("ld_v(") == 2 + 3
    runs = CHECKOUT[CHECKOUT.index("seg_sum_runs_kernel("):]
    assert runs in out


def test_gather_edit_finds_the_checkouts_gather():
    out = segment_variants.with_loads(
        CHECKOUT, "ld.global.nc.L1::evict_last", gather=True)
    assert out.count("ld_v(x + d)") == 1
    assert out.count("__ldg(x + d)") == CHECKOUT.count("__ldg(x + d)") - 1


def test_missing_anchor_raises():
    with pytest.raises(ValueError, match="anchor"):
        segment_variants.edit(CHECKOUT, "no such line", "")


@pytest.mark.parametrize("script", [segment_bench, segment_variants])
def test_scripts_need_a_card(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    argv = ["--parent", str(tmp_path / "none.cu")]
    assert script.main(argv) == 1


def test_probe_bench_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot be shown")
    none = str(tmp_path / "none.cu")
    assert probe_bench.main(["--parent-presence", none,
                             "--parent-lookup", none, "--o0"]) == 1


# ------------------------------------------------------------ the lock lint
import lint_locks_torch  # noqa: E402

PORT_RULE1_BAD = """
import torch

class LSMGraph:
    def commit(self):
        with self._lock:
            self._state = torch.zeros(4)  # device work under the commit lock
"""

PORT_RULE2_BAD = """
class ConcurrentLSMGraph:
    def snapshot(self):
        with self.store._flush_lock:
            return self.store.snapshot()
"""


def test_port_lock_lint_passes_on_the_port():
    """The port's store and concurrent wrapper keep both rules, checked
    with torch as device work (the CLI's default targets)."""
    for path in lint_locks_torch.DEFAULT_TARGETS:
        assert Path(path).exists()
        assert lint_locks_torch.lint_source(Path(path).read_text(),
                                            path) == []
    assert lint_locks_torch.main([]) == 0


@pytest.mark.parametrize("src,rule", [(PORT_RULE1_BAD, 1),
                                      (PORT_RULE2_BAD, 2)])
def test_port_lock_lint_catches_seeded_violations(src, rule):
    got = lint_locks_torch.lint_source(src, "seeded.py")
    assert [v.rule for v in got] == [rule]


def test_reference_lock_lint_unchanged():
    """Loading the port's lint leaves the JAX package's lint as it was:
    torch is not device work there."""
    import lint_locks
    assert "torch" not in lint_locks.DEVICE_ROOTS
    assert lint_locks.DEFAULT_TARGETS == ["src/repro/core/store.py"]
    assert lint_locks.lint_source(PORT_RULE1_BAD, "seeded.py") == []
