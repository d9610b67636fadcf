"""Build a CUDA source into a shared library with ``nvcc`` and load it.

Every kernel of the port has a plain C interface and is bound with
``ctypes``, so a build needs no PyTorch headers and takes seconds.  The
library goes to ``build/repro_torch_kernels/`` under a file name that
carries a hash of the source and the flags, and is written under a
temporary name then renamed, so two processes building at once never
load a half-written file.  Nothing is built when a module is imported:
each wrapper calls :func:`load` at its first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Sequence, Tuple

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(_REPO, "build", "repro_torch_kernels")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build repro_torch's kernels")
    return path


def load(source: str, flags: Sequence[str]) -> Tuple[ctypes.CDLL, str]:
    """Compile ``csrc/<source>`` with ``flags`` unless a library built
    from the same source and flags exists, then load it.

    Returns the library and what the compiler printed (empty when the
    library was already built).  Raises ``RuntimeError`` if ``nvcc``
    is missing or fails."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()
                                ).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(source)[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    log = ""
    if not os.path.exists(so):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"({proc.returncode}):\n{proc.stderr}")
            log = proc.stdout + proc.stderr
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(so), log
