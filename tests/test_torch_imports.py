"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the port's scripts in ``tools/`` (kernel timing,
the lock lint, the observability and trajectory smoke gates) imports
``jax``, anything of the JAX package ``repro`` or of the reference's
top-level ``benchmarks`` package (checked on the source, so it holds
whatever is installed)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "segment_bench.py",
    ROOT / "tools" / "segment_variants.py", ROOT / "tools" / "probe_bench.py",
    ROOT / "tools" / "lint_locks_torch.py",
    ROOT / "tools" / "obs_smoke_torch.py",
    ROOT / "tools" / "bench_trajectory_smoke_torch.py"]
BLOCKED = ("jax", "jaxlib", "repro", "benchmarks")


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
                "launch/graph_service.py", "launch/mesh.py",
                "core/distributed.py", "obs/amplification.py",
                "obs/export.py", "obs/trace_export.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    for name in ("common", "run", "smoke", "trajectory", "bench_update",
                 "bench_analytics", "bench_space", "bench_memcache",
                 "bench_index", "bench_mixed", "bench_kernels",
                 "bench_read_batch", "bench_filters", "bench_durability",
                 "bench_sharded"):
        assert (ROOT / "src" / "repro_torch" / "benchmarks" /
                f"{name}.py").exists(), name
    for rel in ("baselines/common.py", "baselines/csr_inplace.py",
                "baselines/lsm_kv.py", "baselines/llama_snapshots.py",
                "baselines/log_append.py", "examples/quickstart.py",
                "examples/streaming_updates.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel
    for rel in ("configs/__init__.py", "configs/base.py",
                "configs/qwen2_1_5b.py", "models/__init__.py",
                "models/layers.py", "models/moe.py", "models/ssm.py",
                "models/model.py", "data/synthetic.py", "launch/serve.py"):
        assert (ROOT / "src" / "repro_torch" / rel).exists(), rel


def test_port_modules_import_without_jax():
    """The shard layer (its mesh write router too), the distributed layer,
    the service, the observability modules and the LM serving path import
    in a fresh interpreter in which ``jax`` and ``repro`` cannot be
    imported at all."""
    import os
    import subprocess
    import sys
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
        "                                  'benchmarks'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import repro_torch.shard, repro_torch.launch.graph_service\n"
        "import repro_torch.obs.amplification, repro_torch.obs.export\n"
        "import repro_torch.obs.trace_export\n"
        "from repro_torch.shard import open_sharded_store\n"
        "import repro_torch.baselines, repro_torch.core.index\n"
        "import repro_torch.benchmarks.run, repro_torch.benchmarks.smoke\n"
        "import repro_torch.benchmarks.trajectory\n"
        "import repro_torch.examples.streaming_updates\n"
        "import repro_torch.core.distributed, repro_torch.launch.mesh\n"
        "from repro_torch.shard import make_mesh_write_router\n"
        "from repro_torch.benchmarks.run import suites\n"
        "import repro_torch.launch.serve, repro_torch.models\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "assert len(ARCH_IDS) == 10\n"
        "assert get_config('qwen2-1.5b').n_layers == 28\n"
        "suites()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{path.name} imports {bad}"
