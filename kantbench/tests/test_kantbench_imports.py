"""No run loads JAX or the JAX package (top-level names compared whole:
``repro_torch`` begins with ``repro``), and the reference imports
nothing of the program.  ``run_cell`` fails on such a module loaded
during its call; each command (``run.py``, ``spans.py``) fails on one
anywhere in its process."""

import inspect
import json
import subprocess
import sys
import textwrap
import types

import pytest

from .conftest import ROOT, cpu_profile
from kantbench import harness

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


#: ``run.py``'s own ``main`` in a process that loaded JAX (a stand-in
#: module) before the run; the check of a card is skipped and the cell
#: run on the CPU, so that all the rest of the command runs as it ships
RUN_WITH_JAX = """
import functools, sys, types
sys.path.insert(0, {checkout!r})
sys.modules["jax"] = types.ModuleType("jax")
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
from kantbench import harness, run
harness.run_cell = functools.partial(harness.run_cell, device="cpu")
sys.exit(run.main(["--workload", "tiny-gangs", "--seed", "5",
                   "--seconds", "0.3"]))
"""


def test_run_refuses_a_process_with_jax_loaded(tiny_root):
    proc = subprocess.run(
        [sys.executable, "-c", RUN_WITH_JAX.format(checkout=tiny_root)],
        cwd=tiny_root, capture_output=True, text=True, timeout=300)
    assert proc.returncode not in (0, 2), proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "modules of the JAX package or of JAX are loaded: jax" in (
        proc.stderr)


#: ``spans.py``'s own ``main`` in a process that loaded JAX before the
#: run, the cell traced on the CPU with the tests' host-only profile
SPANS_WITH_JAX = """
import functools, sys, types
sys.path.insert(0, {checkout!r})
sys.modules["jax"] = types.ModuleType("jax")
import torch
torch.cuda.is_available = lambda: True
from kantbench import harness, spans
{profile}
harness.PROFILE_SECONDS = 0.3
spans.trace_cell = functools.partial(spans.trace_cell, device="cpu",
                                     profile=cpu_profile)
sys.exit(spans.main(["--workload", "tiny-gangs", "--seed", "5",
                     "--seconds", "0.3", "--spans-seconds", "0.3"]))
"""


def test_spans_refuses_a_process_with_jax_loaded(tiny_root):
    profile = textwrap.dedent(inspect.getsource(cpu_profile))
    proc = subprocess.run(
        [sys.executable, "-c", SPANS_WITH_JAX.format(checkout=tiny_root,
                                                     profile=profile)],
        cwd=tiny_root, capture_output=True, text=True, timeout=300)
    assert proc.returncode not in (0, 2), proc.stderr[-2000:]
    assert proc.stdout.strip() == ""
    assert "modules of the JAX package or of JAX are loaded: jax" in (
        proc.stderr)


def jax_imported(monkeypatch):
    """A planted import of a module under ``jax`` by the program."""
    def hook(program):
        monkeypatch.setitem(sys.modules, "jax.kantbench_planted",
                            types.ModuleType("jax.kantbench_planted"))
    return hook


def test_run_cell_refuses_an_import_during_the_run(tiny_root, monkeypatch):
    with pytest.raises(harness.CellError, match="jax.kantbench_planted"):
        harness.run_cell(tiny_root, "tiny-gangs", 5, 0.3, False,
                         device="cpu", on_program=jax_imported(monkeypatch))


def test_run_cell_holds_its_own_call_only(tiny_root, monkeypatch):
    """A module that another test file loaded into this process before
    the call is the command's to refuse, not the call's."""
    monkeypatch.setitem(sys.modules, "repro.kantbench_earlier",
                        types.ModuleType("repro.kantbench_earlier"))
    result = harness.run_cell(tiny_root, "tiny-gangs", 5, 0.3, False,
                              device="cpu")
    assert result["correct"], result["checks"]
