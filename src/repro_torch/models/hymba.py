"""Hymba hybrid block: parallel attention + Mamba(SSM) heads
[arXiv:2411.13676].

The counterpart of the reference package's ``models/hymba.py``.  Each
layer feeds one normalised input to *both* a sliding-window GQA
attention branch and a Mamba-style selective-SSM branch; the two outputs
are normalised separately and averaged (the model adds that block).

SSM branch (diagonal selective scan, state size N = ``ssm_state``)::

    h_t = exp(Δ_t ⊙ A) ⊙ h_{t-1} + Δ_t ⊙ (x_t ⊗ B_t)
    y_t = h_t · C_t + D ⊙ x_t

with input-dependent Δ, B, C.  The full sequence runs the recurrence as
a loop over t in f32, in the reference's order (its ``lax.scan``); the
per-step products that do not depend on ``h`` (the decay and the input
term) are computed for a chunk of steps at a time before the loop, and
``y`` for the chunk after it, so the loop itself is one ``addcmul`` a
step.  Decode carries ``h`` explicitly: O(1) state.  The reference has
no kernel here; its sharding hint on ``u`` stands where it stands.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..loops import trip_range
from ..sharding.context import constrain, local_einsum
from .layers import Params, dense_init, init_attn, spec_attn

DT_RANK = 32
#: Steps whose decay and input terms are held at once by ``ssm_scan``:
#: (chunk, B, d, N) f32 each, 52 MB at B=4 for hymba-1.5b.
SCAN_CHUNK = 128


def init_ssm(generator: torch.Generator, d_model: int, n_state: int, dtype,
             out_scale: float = 1.0) -> Params:
    dev = generator.device
    return {
        "w_in": dense_init(generator, (d_model, d_model), dtype),
        "w_bc": dense_init(generator, (d_model, 2 * n_state), dtype),
        "w_dt": dense_init(generator, (d_model, DT_RANK), dtype),
        "w_dt2": dense_init(generator, (DT_RANK, d_model), dtype),
        "a_log": torch.zeros((d_model, n_state), dtype=dtype,
                             device=dev),            # A = -exp(a_log)
        "d_skip": torch.ones((d_model,), dtype=dtype, device=dev),
        "w_out": dense_init(generator, (d_model, d_model), dtype,
                            scale=out_scale / math.sqrt(d_model)),
    }


def spec_ssm(d_model: int, n_state: int) -> Dict[str, Tuple[int, ...]]:
    return {"w_in": (d_model, d_model), "w_bc": (d_model, 2 * n_state),
            "w_dt": (d_model, DT_RANK), "w_dt2": (DT_RANK, d_model),
            "a_log": (d_model, n_state), "d_skip": (d_model,),
            "w_out": (d_model, d_model)}


def ssm_state_shape(batch: int, d_model: int, n_state: int
                    ) -> Tuple[int, int, int]:
    return (batch, d_model, n_state)


def _ssm_inputs(p: Params, x: torch.Tensor):
    """x: (B, T, d) -> (u, dt, B_t, C_t) selective-scan inputs."""
    u = constrain(F.silu(x @ p["w_in"]),
                  ("batch", None, "model"))              # (B,T,d)
    bc = x @ p["w_bc"]
    n = p["a_log"].shape[-1]
    B_t, C_t = bc[..., :n], bc[..., n:]                     # (B,T,N)
    dt = F.softplus((x @ p["w_dt"]) @ p["w_dt2"])           # (B,T,d)
    return u, dt, B_t, C_t


def selective_scan(u: torch.Tensor, dt: torch.Tensor, B_t: torch.Tensor,
                   C_t: torch.Tensor, A: torch.Tensor, h: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over t, f32.  u, dt: (B,T,d); B_t, C_t: (B,T,N);
    A: (d,N); h: (B,d,N).  Returns (y (B,T,d) f32, h_T)."""
    T = u.shape[1]
    # Time-major, so that step t of each chunk is one contiguous (B,d,N).
    u, dt, B_t, C_t = (a.transpose(0, 1).to(torch.float32)
                       for a in (u, dt, B_t, C_t))
    h = h.to(torch.float32)

    def chunk(t0: int) -> torch.Tensor:
        nonlocal h
        sl = slice(t0, t0 + SCAN_CHUNK)
        decay = torch.exp(dt[sl, ..., None] * A)            # (c,B,d,N)
        inp = (dt[sl] * u[sl])[..., None] * B_t[sl, :, None, :]
        steps = []
        trips = trip_range(decay.shape[0], decay)
        for i in trips:
            h = torch.addcmul(inp[i], decay[i], h)
            steps.append(h)
        hs = torch.stack(trips.full(steps))
        return local_einsum("tbdn,tbn->tbd", hs, C_t[sl])

    # The full chunks, then the ragged last one: the dry-run's op counter
    # runs one full chunk for all (trip_range); otherwise every chunk.
    full = trip_range(T // SCAN_CHUNK, u)
    ys = full.full([chunk(c * SCAN_CHUNK) for c in full])
    if T % SCAN_CHUNK:
        ys.append(chunk(T - T % SCAN_CHUNK))
    return torch.cat(ys).transpose(0, 1), h


def ssm_scan(p: Params, x: torch.Tensor, h0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence selective scan.  x: (B,T,d); h0: (B,d,N)."""
    u, dt, B_t, C_t = _ssm_inputs(p, x)
    A = -torch.exp(p["a_log"].to(torch.float32))            # (d,N)
    y, h = selective_scan(u, dt, B_t, C_t, A, h0)
    y = y.to(x.dtype) + u * p["d_skip"]
    return y @ p["w_out"], h


def ssm_step(p: Params, x: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token selective scan.  x: (B,1,d); h: (B,d,N)."""
    u, dt, B_t, C_t = _ssm_inputs(p, x)
    A = -torch.exp(p["a_log"].to(torch.float32))
    u1, dt1 = u[:, 0].to(torch.float32), dt[:, 0].to(torch.float32)
    b1, c1 = B_t[:, 0].to(torch.float32), C_t[:, 0].to(torch.float32)
    decay = torch.exp(dt1[..., None] * A[None])
    h = decay * h.to(torch.float32) + (dt1 * u1)[..., None] * b1[:, None]
    y = local_einsum("bdn,bn->bd", h, c1)[:, None, :].to(x.dtype)
    y = y + u * p["d_skip"]
    return y @ p["w_out"], h


def init_hymba_block(generator: torch.Generator, d_model: int,
                     n_heads: int, n_kv: int, head_dim: int, n_state: int,
                     dtype, out_scale: float = 1.0) -> Params:
    dev = generator.device
    return {
        "attn": init_attn(generator, d_model, n_heads, n_kv, head_dim,
                          dtype, out_scale=out_scale),
        "ssm": init_ssm(generator, d_model, n_state, dtype,
                        out_scale=out_scale),
        "norm_attn_out": torch.ones((d_model,), dtype=dtype, device=dev),
        "norm_ssm_out": torch.ones((d_model,), dtype=dtype, device=dev),
    }


def spec_hymba_block(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                     n_state: int) -> Dict[str, Tuple[int, ...]]:
    return {"attn": spec_attn(d_model, n_heads, n_kv, head_dim),
            "ssm": spec_ssm(d_model, n_state),
            "norm_attn_out": (d_model,), "norm_ssm_out": (d_model,)}
