"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the port's scripts in ``tools/`` (kernel timing,
the lock lint) imports ``jax`` or anything of the JAX package ``repro``
(checked on the source, so it holds whatever is installed)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "segment_bench.py",
    ROOT / "tools" / "segment_variants.py", ROOT / "tools" / "probe_bench.py",
    ROOT / "tools" / "lint_locks_torch.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_found():
    assert len(FILES) > 10
    assert (ROOT / "src" / "repro_torch" / "csrc" / "presence.cu").exists()
    assert (ROOT / "src" / "repro_torch" / "csrc" / "merge_perm.cu").exists()
    for name in ("segment_reduce", "lookup", "flash_attention"):
        assert (ROOT / "src" / "repro_torch" / "csrc" /
                f"{name}.cu").exists()
    for name in ("errors", "faultfs", "fsutil", "wal", "manifest",
                 "segments", "scrub", "engine", "recovery", "chaostest",
                 "crashtest", "__init__"):
        assert (ROOT / "src" / "repro_torch" / "storage" /
                f"{name}.py").exists()
    assert (ROOT / "src" / "repro_torch" / "core" / "concurrent.py").exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"
