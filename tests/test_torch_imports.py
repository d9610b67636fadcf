"""The port imports neither JAX nor anything of the JAX package, and its
chip smoke refuses to run without a card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

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
