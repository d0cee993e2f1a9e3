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
    for rel in ("shard/__init__.py", "shard/partition.py", "shard/router.py",
                "shard/store.py", "shard/scheduler.py", "launch/__init__.py",
                "launch/graph_service.py", "obs/amplification.py",
                "obs/export.py", "obs/trace_export.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel


def test_port_modules_import_without_jax():
    """The shard layer, the service and the observability modules import
    in a fresh interpreter in which ``jax`` and ``repro`` cannot be
    imported at all."""
    import os
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.shard, repro_torch.launch.graph_service\n"
        "import repro_torch.obs.amplification, repro_torch.obs.export\n"
        "import repro_torch.obs.trace_export\n"
        "from repro_torch.shard import open_sharded_store\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"
