"""CUDA kernels of the fused node filter+score pass, and their wrappers.

The kernels (``csrc/node_score.cu``) replace the Pallas TPU kernels
``_score_kernel`` and ``_score_slots_kernel`` of the reference package's
``kernels/node_score.py``.  They are built at first use with ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/`` (a plain C interface,
no PyTorch headers, so the build takes seconds) and loaded with
``ctypes``.

Each wrapper takes the plain torch version (:mod:`.ref`) only for
tensors that lie on the CPU.  For CUDA tensors it checks device, dtype,
shape and contiguity, launches the kernel on the current stream, and
raises if anything is off or the launch is refused: there is no
fallback.  ``launches`` on each wrapper counts kernel launches and
nothing else.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import torch

from . import _build
from .ref import node_scores_ref, node_scores_slots_ref

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library
    (:func:`._build.load`)."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib, _ = _build.load("node_score.cu", NVCC_FLAGS)
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                          ctypes.c_float)
    lib.node_scores_launch.argtypes = [ptr] * 6 + [i64, i32] + [f32] * 5 + [
        ptr]
    lib.node_scores_launch.restype = ctypes.c_int
    lib.node_scores_slots_launch.argtypes = [ptr] * 7 + [i64, i32] + [
        f32] * 5 + [ptr]
    lib.node_scores_slots_launch.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def _check(free, used, mask, group_load, topo_pref) -> int:
    """Validate the node-table columns for a kernel launch; returns n."""
    want = ((free, torch.int32, "free"), (used, torch.int32, "used"),
            (mask, torch.bool, "mask"),
            (group_load, torch.float32, "group_load"),
            (topo_pref, torch.float32, "topo_pref"))
    dev = free.device
    n = free.shape[0] if free.dim() == 1 else -1
    for t, dtype, name in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, free on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} must have shape ({n},), got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return n


def _launch(fn, cols, outs, n: int, request: int, gpus_per_node: int,
            weights: Tuple[float, float, float, float]) -> None:
    if request <= 0:
        raise ValueError(f"request must be positive, got {request}")
    dev = cols[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in cols),
                 *(t.data_ptr() for t in outs), n, request,
                 float(gpus_per_node), *(float(w) for w in weights), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def node_scores(free: torch.Tensor, used: torch.Tensor, mask: torch.Tensor,
                group_load: torch.Tensor, topo_pref: torch.Tensor, *,
                request: int, gpus_per_node: int, w_used: float,
                w_fit: float, w_group: float, w_topo: float
                ) -> torch.Tensor:
    """Score-only pass (per-pod path): (n,) f32, ``NEG_INF`` where
    invalid.  Columns: int32 free/used, bool mask, f32 group_load and
    topo_pref, all 1-D, contiguous, on one device."""
    w = dict(w_used=w_used, w_fit=w_fit, w_group=w_group, w_topo=w_topo)
    if free.device.type == "cpu":
        return node_scores_ref(free, used, mask, group_load, topo_pref,
                               request=request, gpus_per_node=gpus_per_node,
                               **w)
    cols = (free, used, mask, group_load, topo_pref)
    n = _check(*cols)
    score = torch.empty(n, dtype=torch.float32, device=free.device)
    if n == 0:
        return score
    _launch(build().node_scores_launch, cols, (score,), n, request,
            gpus_per_node, (w_used, w_fit, w_group, w_topo))
    node_scores.launches += 1
    return score


def node_scores_slots(free: torch.Tensor, used: torch.Tensor,
                      mask: torch.Tensor, group_load: torch.Tensor,
                      topo_pref: torch.Tensor, *, request: int,
                      gpus_per_node: int, w_used: float, w_fit: float,
                      w_group: float, w_topo: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score + slots pass (batched gang path): ``(scores f32, slots
    int32)`` with slots = ``free // request`` where valid, else 0."""
    w = dict(w_used=w_used, w_fit=w_fit, w_group=w_group, w_topo=w_topo)
    if free.device.type == "cpu":
        return node_scores_slots_ref(
            free, used, mask, group_load, topo_pref, request=request,
            gpus_per_node=gpus_per_node, **w)
    cols = (free, used, mask, group_load, topo_pref)
    n = _check(*cols)
    score = torch.empty(n, dtype=torch.float32, device=free.device)
    slots = torch.empty(n, dtype=torch.int32, device=free.device)
    if n == 0:
        return score, slots
    _launch(build().node_scores_slots_launch, cols, (score, slots), n,
            request, gpus_per_node, (w_used, w_fit, w_group, w_topo))
    node_scores_slots.launches += 1
    return score, slots


node_scores.launches = 0
node_scores_slots.launches = 0
