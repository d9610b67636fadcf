"""CUDA kernels of the RWKV-6 WKV recurrence, and their wrappers.

The chunked kernels (``csrc/wkv6.cu``, ``wkv6_launch``: a pass over all
chunks in parallel, then a serial scan over chunk boundaries) replace the
Pallas TPU kernel ``_wkv_kernel`` of the reference package's
``kernels/wkv6.py``; :func:`wkv6` runs them, and every caller of the port
goes through that wrapper, which allocates their scratch.  The library is
built at first use with ``nvcc`` for ``sm_90a`` (:mod:`._build`) and
loaded with ``ctypes``.

The wrapper takes the plain torch version (:func:`.ref.wkv6_ref`) only
for tensors that lie on the CPU.  For CUDA tensors it checks device,
dtype, shape and contiguity, launches its kernel on the current stream,
and raises if anything is off or the launch is refused: there is no
fallback.  ``wkv6.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional, Tuple

import torch

from . import _build
from .ref import wkv6_ref

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_HEAD_SIZE = 64
#: steps per chunk of the chunked kernels (``kChunk`` in ``csrc/wkv6.cu``);
#: :func:`.ref.wkv6_chunked_ref` mirrors it at this chunk size.
CHUNK = 16
STREAM_DTYPES = (torch.float32, torch.bfloat16)

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
#: what ``ptxas -v`` printed (registers, shared memory, spills) when this
#: process built the library; empty when it was already built.
build_log = ""


def build() -> ctypes.CDLL:
    """Compile (once per source and flags) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    lib, build_log = _build.load("wkv6.cu", NVCC_FLAGS)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.wkv6_launch.argtypes = [ptr] * 9 + [i64, i64, i32, i32, i32, ptr]
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_scratch_floats.argtypes = [i64, i64, i32, i32]
    lib.wkv6_scratch_floats.restype = i64
    build_seconds = time.perf_counter() - t0
    _lib = lib
    return lib


def _check(r, k, v, w, u, s0) -> Tuple[int, int, int, int]:
    """Validate a kernel launch's inputs; returns (B, T, H, n)."""
    dev = r.device
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, n), got {tuple(r.shape)}")
    B, T, H, n = r.shape
    if T < 1:
        raise ValueError(f"T must be at least 1, got {T}")
    if n > MAX_HEAD_SIZE:
        raise ValueError(f"head size {n} > {MAX_HEAD_SIZE}: the kernel "
                         f"sizes its tiles and registers for at most that")
    want = ((r, "r", (B, T, H, n), STREAM_DTYPES),
            (k, "k", (B, T, H, n), STREAM_DTYPES),
            (v, "v", (B, T, H, n), STREAM_DTYPES),
            (w, "w", (B, T, H, n), STREAM_DTYPES),
            (u, "u", (H, n), (torch.float32,)),
            (s0, "s0", (B, H, n, n), (torch.float32,)))
    for t, name, shape, dtypes in want:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, r on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, T, H, n


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV over a full sequence, on the chunked kernels.

    r, k, v, w: (B, T, H, n), each f32 or bf16, contiguous; u: (H, n)
    f32; s0: (B, H, n, n) f32; n <= 64, T >= 1.  Returns (o (B, T, H, n)
    f32, S_T (B, H, n, n) f32).  Raises on anything the kernels do not
    take and on a refused launch."""
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    B, T, H, n = _check(r, k, v, w, u, s0)
    o = torch.empty((B, T, H, n), dtype=torch.float32, device=r.device)
    sT = torch.empty((B, H, n, n), dtype=torch.float32, device=r.device)
    bf16_mask = sum(1 << i for i, t in enumerate((r, k, v, w))
                    if t.dtype == torch.bfloat16)
    lib = build()
    scratch = torch.empty(lib.wkv6_scratch_floats(B, T, H, n),
                          dtype=torch.float32, device=r.device)
    ptrs = [t.data_ptr() for t in (r, k, v, w, u, s0, o, sT, scratch)]
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_launch(*ptrs, B, T, H, n, bf16_mask, stream)
    if err != 0:
        raise RuntimeError(f"wkv6_launch failed: CUDA error {err}")
    wkv6.launches += 1
    return o, sT


wkv6.launches = 0
