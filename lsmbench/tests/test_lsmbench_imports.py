"""What a run loads: no module whose top-level name is ``jax`` or the JAX
package's (``repro``; the port ``repro_torch`` is another name), and the
reference loads nothing of the program."""
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

LOAD_ALL = r"""
import importlib, json, sys
from pathlib import Path
root, bench = Path(sys.argv[1]), Path(sys.argv[2])
sys.path[:0] = [str(root), str(root / "src")]
from lsmbench import spec
names = []
for path in sorted(bench.rglob("*.py")):
    rel = path.relative_to(root).with_suffix("")
    if "tests" in rel.parts:
        continue
    if path.parent.name == "metrics":
        spec.load_reader(path)
    elif path.parent.name == "ops" and path.stem != "__init__":
        spec.load_op(path.stem)
    else:
        importlib.import_module(".".join(p for p in rel.parts
                                         if p != "__init__"))
    names.append(str(rel))
print(json.dumps({"loaded": names,
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE_ONLY = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import lsmbench.reference
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _fresh(code):
    p = subprocess.run([sys.executable, "-c", code, str(ROOT), str(BENCH)],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    import json
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    out = _fresh(LOAD_ALL)
    assert any(n.endswith("harness") for n in out["loaded"])
    assert any("metrics" in n for n in out["loaded"])
    for bad in ("jax", "jaxlib", "flax", "repro"):
        assert bad not in out["top"], bad


def test_the_reference_loads_nothing_of_the_program():
    top = _fresh(REFERENCE_ONLY)
    assert "repro_torch" not in top and "repro" not in top
    assert "jax" not in top


def test_the_harness_names_what_it_refuses():
    from lsmbench.harness import FORBIDDEN_MODULES, forbidden_modules
    assert set(FORBIDDEN_MODULES) == {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" not in forbidden_modules()
    sys.modules["repro"] = type(sys)("repro")
    try:
        assert "repro" in forbidden_modules()
    finally:
        del sys.modules["repro"]
