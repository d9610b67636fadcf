"""The port imports neither JAX nor anything of the JAX package, nor do
its examples; its chip smoke and its examples refuse to run without a
card unless the host is asked for."""

import ast
import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ("quickstart", "custom_plugins", "inference_cluster",
            "tidal_cosched", "cosched_demo", "train_e2e")

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "repro" or m.startswith("repro.")
             or (m == "jax" and sys.modules[m] is not None)
             or m.startswith("jax."))
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
"""

#: Modules of the co-scheduling slice, which the walk must reach.
COSCHED = ("repro_torch.core.dynamics", "repro_torch.core.dynamics.engine",
           "repro_torch.core.dynamics.failures",
           "repro_torch.core.dynamics.recovery",
           "repro_torch.core.dynamics.tidal", "repro_torch.core.pipeline",
           "repro_torch.core.framework.contrib", "repro_torch.serve.metrics",
           "repro_torch.serve.router", "repro_torch.serve.requests",
           "repro_torch.serve.replica")

#: Modules of the elastic, federation and self-tuning slice.
ELASTIC_FEDERATION_TUNING = (
    "repro_torch.launch.combo_cache", "repro_torch.core.elastic",
    "repro_torch.core.elastic.spec", "repro_torch.core.elastic.estimate",
    "repro_torch.core.elastic.policy", "repro_torch.core.elastic.manager",
    "repro_torch.core.federation", "repro_torch.core.federation.summary",
    "repro_torch.core.federation.member",
    "repro_torch.core.federation.plugins",
    "repro_torch.core.federation.gsch", "repro_torch.core.federation.metrics",
    "repro_torch.core.federation.simulator", "repro_torch.core.tuning",
    "repro_torch.core.tuning.params", "repro_torch.core.tuning.profile",
    "repro_torch.core.tuning.manager", "repro_torch.core.tuning.controllers")

#: The telemetry layer.
OBS = ("repro_torch.obs", "repro_torch.obs.registry", "repro_torch.obs.trace",
       "repro_torch.obs.audit", "repro_torch.obs.telemetry",
       "repro_torch.obs.report")

#: Meshes, the placement cost model and the auto-sharder.
SHARDING = ("repro_torch.launch.mesh", "repro_torch.launch.cosched",
            "repro_torch.sharding", "repro_torch.sharding.auto",
            "repro_torch.sharding.context")


#: The dry-run and its cost model.
DRYRUN = ("repro_torch.launch.op_analysis", "repro_torch.launch.dryrun",
          "repro_torch.launch.profile")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names = out.stdout.splitlines()[:2]
    assert int(count.split()[0]) >= 20
    assert set(COSCHED) <= set(names.split())
    assert set(ELASTIC_FEDERATION_TUNING) <= set(names.split())
    assert set(OBS) <= set(names.split())
    assert set(SHARDING) <= set(names.split())
    assert set(DRYRUN) <= set(names.split())


#: The scheduler's path down to the kernels, and what it must not load:
#: the dry-run's cost model and what that module brings (DTensor, the
#: flop counter, sympy).
SCHEDULER_PATH = ("repro_torch.core", "repro_torch.core.scoring",
                  "repro_torch.kernels.node_score", "repro_torch.kernels.ops",
                  "repro_torch.kernels.wkv6", "repro_torch.kernels.ref")
COST_MODEL = ("repro_torch.launch.op_analysis", "torch.distributed.tensor",
              "torch.utils.flop_counter", "sympy")


def test_scheduler_path_imports_no_cost_model():
    code = (f"import importlib, sys\n"
            f"for name in {SCHEDULER_PATH!r}:\n"
            f"    importlib.import_module(name)\n"
            f"print(sorted(m for m in {COST_MODEL!r} if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[0] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_ast_scan_finds_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py"))
    assert files
    offenders = [(str(f.relative_to(ROOT)), name)
                 for f in files for name in _imports(f)
                 if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert offenders == []


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA here: the smoke exits non-zero and prints no result, both
    from the checkout and alone in an empty directory."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    bare = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, env in ((ROOT / "chip_smoke.py", _env()), (alone, bare)):
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_examples_import_no_jax_or_reference():
    files = [ROOT / "examples" / f"{name}_torch.py" for name in EXAMPLES]
    offenders = [(f.name, name) for f in files for name in _imports(f)
                 if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert offenders == []
    assert all("repro_torch" in set(n.split(".")[0] for n in _imports(f))
               for f in files)


def _example(name):
    """``examples/<name>.py``, loaded once per process under ``name``
    (custom_plugins registers a plugin at import, which the registry
    takes once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_asked_for_cuda_raises_without_it(name, monkeypatch):
    """No fallback: ``--device cuda`` where no CUDA device is visible
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _example(f"{name}_torch").main(["--device", "cuda"])
