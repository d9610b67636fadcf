"""No run loads JAX or the JAX package (top-level names compared whole:
``repro_torch`` begins with ``repro``), and the reference imports
nothing of the program."""

import json
import subprocess
import sys

from conftest import ROOT

RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from kantbench import harness
result = harness.run_cell({checkout!r}, "tiny-gangs", 5, 0.3, False,
                          device="cpu")
print(json.dumps({{"correct": result["correct"],
                  "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_run_loads_no_jax(tiny_root):
    proc = subprocess.run(
        [sys.executable, "-c", RUN.format(root=ROOT, src=ROOT + "/src",
                                          checkout=tiny_root)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "repro_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])


def test_reference_imports_no_program():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import kantbench.reference, kantbench.inputs, "
            "kantbench.generators.stationary; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    tops = proc.stdout
    for name in ("repro_torch", "'repro'", "jax", "torch"):
        assert name not in tops


def test_run_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's own
    files gives no result: the program is imported from its ``src``."""
    import shutil
    root = tmp_path / "bare"
    shutil.copytree(ROOT + "/kantbench", root / "kantbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT + "/BENCHMARK.json", root / "BENCHMARK.json")
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from kantbench import harness; "
            f"print(harness.run_cell({str(root)!r}, 'gang64-80k', 1, 0.1, "
            "False, device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "repro_torch" in proc.stderr
