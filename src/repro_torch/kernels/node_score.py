"""CUDA kernels of the fused node filter+score pass, and their wrappers.

The kernels (``csrc/node_score.cu``) replace the Pallas TPU kernels
``_score_kernel`` and ``_score_slots_kernel`` of the reference package's
``kernels/node_score.py``.  They are built at first use with ``nvcc``
for ``sm_90a`` into ``build/repro_torch_kernels/`` (a plain C interface,
no PyTorch headers, so the build takes seconds) and loaded with
``ctypes``.  The kernel takes its 16-byte vector path when every column
and output is 16-byte aligned, else its scalar path; it chooses from the
pointers, so a view at an odd offset is scored correctly either way.

Each wrapper takes the plain torch version (:mod:`.ref`) only for
tensors that lie on the CPU.  For CUDA tensors it checks device, dtype,
shape and contiguity (of the columns and of ``out=`` where given),
launches the kernel on the current stream, and raises if anything is off
or the launch is refused: there is no fallback.  ``launches`` on each
wrapper counts kernel launches and nothing else.  :func:`noop` launches
an empty kernel on the same path, to time the launch floor.

The packed seam of ``core/scoring.py`` makes the same checks once per
staging layout instead of once per pass: :func:`staged_plan` checks the
layout's buffers and views and fixes their addresses, and
:func:`staged_launch` enqueues a whole pass through the plan (the copy
up, the kernel, the copy down) in one foreign call, counted on the
wrapper whose kernel it runs.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import torch

from . import _build
from .ref import node_scores_ref, node_scores_slots_ref

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
#: what ``ptxas -v`` printed (registers, shared memory, spills) when this
#: process built the library; empty when it was already built.
build_log = ""


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library
    (:func:`._build.load`)."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib, build_log = _build.load("node_score.cu", NVCC_FLAGS)
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                          ctypes.c_float)
    lib.node_scores_launch.argtypes = [ptr] * 6 + [i64, i32] + [f32] * 5 + [
        ptr]
    lib.node_scores_slots_launch.argtypes = [ptr] * 7 + [i64, i32] + [
        f32] * 5 + [ptr]
    lib.node_score_noop_launch.argtypes = [ptr]
    lib.node_scores_staged_launch.argtypes = [ptr, i32] + [f32] * 5 + [ptr]
    for fn in (lib.node_scores_launch, lib.node_scores_slots_launch,
               lib.node_score_noop_launch, lib.node_scores_staged_launch):
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def _check_like(dev: torch.device, n: int, want) -> None:
    """Raise unless every ``(tensor, dtype, name)`` in ``want`` is a
    contiguous (n,) tensor of that dtype on ``dev``."""
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


def _check(free, used, mask, group_load, topo_pref) -> int:
    """Validate the node-table columns for a kernel launch; returns n."""
    n = free.shape[0] if free.dim() == 1 else -1
    _check_like(free.device, n, (
        (free, torch.int32, "free"), (used, torch.int32, "used"),
        (mask, torch.bool, "mask"),
        (group_load, torch.float32, "group_load"),
        (topo_pref, torch.float32, "topo_pref")))
    return n


def _check_out_pair(dev: torch.device, n: int, out) -> None:
    """Validate ``out=`` of the score+slots pass: (scores f32, slots
    int32), each a contiguous (n,) tensor on ``dev``."""
    if len(out) != 2:
        raise ValueError("out must be a (scores, slots) pair")
    _check_like(dev, n, ((out[0], torch.float32, "out[0]"),
                         (out[1], torch.int32, "out[1]")))


def fill(score: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """A computed score vector, or ``out`` (checked) filled with it."""
    if out is None:
        return score
    _check_like(score.device, score.shape[0], ((out, torch.float32, "out"),))
    return out.copy_(score)


def fill_pair(score: torch.Tensor, slots: torch.Tensor, out
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Computed (scores, slots), or the ``out`` pair (checked) filled
    with them."""
    if out is None:
        return score, slots
    _check_out_pair(score.device, score.shape[0], out)
    return out[0].copy_(score), out[1].copy_(slots)


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


def noop(device: torch.device) -> None:
    """Launch the empty kernel on ``device``'s current stream, through
    the same ctypes path as the passes (not counted: it is no pass)."""
    fn = build().node_score_noop_launch
    with torch.cuda.device(device):
        err = fn(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"node_score_noop_launch failed: CUDA error {err}")


def node_scores(free: torch.Tensor, used: torch.Tensor, mask: torch.Tensor,
                group_load: torch.Tensor, topo_pref: torch.Tensor, *,
                request: int, gpus_per_node: int, w_used: float,
                w_fit: float, w_group: float, w_topo: float,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Score-only pass (per-pod path): (n,) f32, ``NEG_INF`` where
    invalid.  Columns: int32 free/used, bool mask, f32 group_load and
    topo_pref, all 1-D, contiguous, on one device.  ``out``, if given,
    is a contiguous (n,) f32 tensor on that device; it is filled and
    returned."""
    w = dict(w_used=w_used, w_fit=w_fit, w_group=w_group, w_topo=w_topo)
    cols = (free, used, mask, group_load, topo_pref)
    if free.device.type == "cpu":
        return fill(node_scores_ref(*cols, request=request,
                                    gpus_per_node=gpus_per_node, **w), out)
    n = _check(*cols)
    if out is not None:
        _check_like(free.device, n, ((out, torch.float32, "out"),))
    score = out if out is not None else torch.empty(
        n, dtype=torch.float32, device=free.device)
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
                      w_group: float, w_topo: float,
                      out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score + slots pass (batched gang path): ``(scores f32, slots
    int32)`` with slots = ``free // request`` where valid, else 0.
    ``out``, if given, is a ``(scores, slots)`` pair of contiguous (n,)
    f32 and int32 tensors on the columns' device; it is filled and
    returned."""
    w = dict(w_used=w_used, w_fit=w_fit, w_group=w_group, w_topo=w_topo)
    cols = (free, used, mask, group_load, topo_pref)
    if free.device.type == "cpu":
        return fill_pair(*node_scores_slots_ref(
            *cols, request=request, gpus_per_node=gpus_per_node, **w), out)
    n = _check(*cols)
    if out is not None:
        _check_out_pair(free.device, n, out)
        score, slots = out
    else:
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


class StagedPlan(ctypes.Structure):
    """One staging layout of the packed seam as ``node_scores_staged_launch``
    reads it (``struct StagedPlan`` in ``csrc/node_score.cu``): the raw
    addresses and byte counts of the host and device input ranges, the
    five device columns, the device outputs (``slots`` 0 for the
    score-only pass) and the device and host output ranges.  Made by
    :func:`staged_plan`; ``address`` is where the C side reads it and
    ``counter`` the wrapper its passes count on."""

    _fields_ = [("host_in", ctypes.c_void_p), ("dev_in", ctypes.c_void_p),
                ("in_bytes", ctypes.c_int64),
                ("cols", ctypes.c_void_p * 5),
                ("score", ctypes.c_void_p), ("slots", ctypes.c_void_p),
                ("dev_out", ctypes.c_void_p), ("host_out", ctypes.c_void_p),
                ("out_bytes", ctypes.c_int64), ("n", ctypes.c_int64),
                ("device", ctypes.c_int64)]


def _check_range(t: torch.Tensor, dev: torch.device, pinned: bool,
                 name: str) -> None:
    """Raise unless ``t`` is a contiguous 1-D uint8 range on ``dev``,
    in pinned memory where ``pinned``."""
    _check_like(dev, t.shape[0] if t.dim() == 1 else -1,
                ((t, torch.uint8, name),))
    if pinned and not t.is_pinned():
        raise ValueError(f"{name} must be in pinned host memory")


def _check_inside(views, rng: torch.Tensor, name: str) -> None:
    """Raise unless every view lies inside the byte range ``rng`` and
    starts on a 16-byte boundary (the kernel's vector path)."""
    lo = rng.data_ptr()
    hi = lo + rng.numel()
    for i, t in enumerate(views):
        a = t.data_ptr()
        if a < lo or a + t.numel() * t.element_size() > hi:
            raise ValueError(f"{name}[{i}] lies outside its copied range")
        if a % 16:
            raise ValueError(f"{name}[{i}] is not 16-byte aligned")


def staged_plan(up, cols, outs, down) -> StagedPlan:
    """The plan of one staging layout: ``up`` the (device, host) byte
    ranges copied up, ``cols`` the five device columns inside ``up[0]``,
    ``outs`` the device scores, or (scores, slots), inside ``down[1]``,
    ``down`` the (host, device) byte ranges copied down.

    Checks once what every pass through the plan relies on, as
    :func:`node_scores_slots` and :func:`node_scores` check their
    arguments at every call: the columns' and the outputs' dtypes,
    lengths, contiguity and device (:func:`_check`, :func:`_check_like`),
    and besides that each range's dtype, device and (on a card) pinned
    host memory, equal lengths each way, and every view inside its range
    on a 16-byte boundary.  Raises ``TypeError`` or ``ValueError``."""
    n = _check(*cols)
    dev = cols[0].device
    if len(outs) == 2:
        _check_out_pair(dev, n, outs)
    else:
        _check_like(dev, n, ((outs[0], torch.float32, "out"),))
    on_card = dev.type != "cpu"
    host = torch.device("cpu")
    for (t, where, name) in ((up[0], dev, "up[0]"), (up[1], host, "up[1]"),
                             (down[0], host, "down[0]"),
                             (down[1], dev, "down[1]")):
        _check_range(t, where, on_card and where == host, name)
    for pair, name in ((up, "up"), (down, "down")):
        if pair[0].numel() != pair[1].numel():
            raise ValueError(f"the {name} ranges differ in length")
    _check_inside(cols, up[0], "cols")
    _check_inside(outs, down[1], "outs")
    plan = StagedPlan(host_in=up[1].data_ptr(), dev_in=up[0].data_ptr(),
                      in_bytes=up[0].numel(), score=outs[0].data_ptr(),
                      slots=outs[1].data_ptr() if len(outs) == 2 else None,
                      dev_out=down[1].data_ptr(),
                      host_out=down[0].data_ptr(),
                      out_bytes=down[0].numel(), n=n,
                      device=dev.index if on_card else -1)
    plan.cols[:] = [t.data_ptr() for t in cols]
    plan.address = ctypes.addressof(plan)
    plan.counter = node_scores_slots if len(outs) == 2 else node_scores
    return plan


def staged_launch(plan: StagedPlan, request: int, gpus_per_node: int,
                  w_used: float, w_fit: float, w_group: float,
                  w_topo: float, stream: int) -> None:
    """Enqueue one pass of the packed seam through ``plan`` on ``stream``
    (a ``cudaStream_t`` as an int): the copy up, the kernel over the
    plan's columns, the copy down, in one foreign call.  Counted as one
    launch of the wrapper whose kernel it runs; raises if the request is
    not positive or CUDA refuses any of the three."""
    if request <= 0:
        raise ValueError(f"request must be positive, got {request}")
    err = build().node_scores_staged_launch(
        plan.address, int(request), float(gpus_per_node), float(w_used),
        float(w_fit), float(w_group), float(w_topo), stream)
    if err != 0:
        raise RuntimeError(
            f"node_scores_staged_launch failed: CUDA error {err}")
    if plan.n:
        plan.counter.launches += 1
