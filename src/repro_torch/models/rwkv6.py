"""RWKV-6 "Finch" block: data-dependent decay linear attention
[arXiv:2404.05892].

The counterpart of the reference package's ``models/rwkv6.py``.  Per
head ``h`` with head_dim ``n`` the time-mix recurrence over state
``S_t ∈ R^{n×n}`` is::

    S_t = diag(w_t) · S_{t-1} + k_t^T v_t
    o_t = r_t · (S_{t-1} + diag(u) k_t^T v_t)

with the data-dependent decay ``w_t = exp(-exp(wb + W_w · x_t))`` and a
LoRA-style low-rank path for the decay projection.  Token-shift mixes
each input with its predecessor.

A full sequence runs the recurrence through ``kernels.ops.wkv6``:
``backend="kernel"`` is the CUDA kernel (its plain version on CPU
tensors), ``"scan"`` the plain step loop.  Decode carries ``S``
explicitly in plain torch, as the reference does: O(1) state per token.
The reference's sharding hints stand where its hints stand.  Under a
mesh (DTensor streams), the WKV kernel is given each rank's own batch
rows and heads as plain tensors, since a kernel reads ``data_ptr()``
and a DTensor's is not its local shard; WKV is independent per head, so
this is exact at any model-axis size that divides the head count.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import ops
from ..sharding.context import (constrain, local_einsum, local_range,
                                splittable)
from .layers import Params, dense_init

DECAY_LORA = 64
#: ``time_mix`` backend -> ``ops.wkv6`` backend.
_WKV = {"kernel": "kernel", "scan": "ref"}
TIME_MIX_BACKENDS = tuple(_WKV)


def init_rwkv_block(generator: torch.Generator, d_model: int, d_ff: int,
                    head_dim: int, dtype, out_scale: float = 1.0) -> Params:
    """One block's parameters, drawn on ``generator``'s device."""
    H = d_model // head_dim
    dev = generator.device

    def full(shape, value):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def dense(shape, scale=None):
        return dense_init(generator, shape, dtype, scale=scale)

    return {
        "ln_t": full((d_model,), 1.0),
        "ln_c": full((d_model,), 1.0),
        # token-shift mixing coefficients per stream
        "mu": full((5, d_model), 0.5),
        "wr": dense((d_model, d_model)),
        "wk": dense((d_model, d_model)),
        "wv": dense((d_model, d_model)),
        "wg": dense((d_model, d_model)),
        "wo": dense((d_model, d_model), out_scale / math.sqrt(d_model)),
        # data-dependent decay: base + LoRA path
        "decay_base": full((H, head_dim), 0.0),
        "decay_a": dense((d_model, DECAY_LORA)),
        "decay_b": dense((DECAY_LORA, d_model)),
        "bonus_u": full((H, head_dim), 0.5),
        # channel-mix (RWKV FFN): square ReLU
        "ck": dense((d_model, d_ff)),
        "cv": dense((d_ff, d_model), out_scale / math.sqrt(d_ff)),
        "cr": dense((d_model, d_model)),
    }


def spec_rwkv_block(d_model: int, d_ff: int, head_dim: int
                    ) -> Dict[str, Tuple[int, ...]]:
    """The shapes of :func:`init_rwkv_block`'s parameters."""
    H = d_model // head_dim
    return {"ln_t": (d_model,), "ln_c": (d_model,), "mu": (5, d_model),
            "wr": (d_model, d_model), "wk": (d_model, d_model),
            "wv": (d_model, d_model), "wg": (d_model, d_model),
            "wo": (d_model, d_model), "decay_base": (H, head_dim),
            "decay_a": (d_model, DECAY_LORA),
            "decay_b": (DECAY_LORA, d_model), "bonus_u": (H, head_dim),
            "ck": (d_model, d_ff), "cv": (d_ff, d_model),
            "cr": (d_model, d_model)}


def rwkv_state_shape(batch: int, d_model: int, head_dim: int
                     ) -> Tuple[int, int, int, int]:
    H = d_model // head_dim
    return (batch, H, head_dim, head_dim)


def _streams(p: Params, x: torch.Tensor, x_prev: torch.Tensor):
    """Token-shift then project the five RWKV streams.

    x: (B, T, d); x_prev: (B, T, d) (x shifted right by one).  r, k, v
    and g come in ``x``'s type, w in f32.
    """
    B, T, d = x.shape
    mu = p["mu"].to(x.dtype)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    xs = [x * mu[i] + x_prev * (one - mu[i]) for i in range(5)]
    r = constrain(xs[0] @ p["wr"], ("batch", None, "model"))
    k = constrain(xs[1] @ p["wk"], ("batch", None, "model"))
    v = constrain(xs[2] @ p["wv"], ("batch", None, "model"))
    g = constrain(F.silu(xs[3] @ p["wg"]), ("batch", None, "model"))
    dd = torch.tanh(xs[4] @ p["decay_a"]) @ p["decay_b"]
    H, hd = p["decay_base"].shape
    w = torch.exp(-torch.exp(p["decay_base"].to(torch.float32).reshape(-1)
                             + dd.to(torch.float32)))    # (B,T,d) in (0,1)
    shp = (B, T, H, hd)
    r, k, v, w = (splittable(t, -1, H).reshape(shp) for t in (r, k, v, w))
    return r, k, v, g, w


def time_mix(p: Params, x: torch.Tensor, state: torch.Tensor,
             x_last: torch.Tensor, backend: str = "scan"
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix.

    x: (B, T, d) normalized input; state: (B, H, n, n); x_last: (B, d)
    the last pre-norm input of the previous segment (token shift seam).
    Returns (out (B,T,d), new state f32, new x_last).

    ``backend``: "scan" (the plain step loop, the reference's default)
    or "kernel" (the CUDA WKV kernel of :mod:`repro_torch.kernels.wkv6`;
    its plain version on CPU tensors).
    """
    if backend not in _WKV:
        raise ValueError(f"unknown backend {backend!r}; expected "
                         f"{TIME_MIX_BACKENDS}")
    B, T, d = x.shape
    x_prev = torch.cat([x_last[:, None, :], x[:, :-1]], dim=1)
    r, k, v, g, w = _streams(p, x, x_prev)
    u = p["bonus_u"].to(torch.float32)
    wkv = _wkv6_local if isinstance(r, DTensor) else ops.wkv6
    o4, state = wkv(r, k, v, w, u, state, backend=_WKV[backend])
    o = splittable(o4.reshape(B, T, d), -1, o4.shape[2])
    out = (o.to(x.dtype) * g) @ p["wo"]
    return out, state, x[:, -1]


def _wkv6_local(r, k, v, w, u, state, backend: str):
    """``ops.wkv6`` on DTensor streams (B, T, H, n): each rank runs it on
    its own batch rows and heads as plain tensors, with ``u`` and the
    initial state sliced to them, and the outputs are wrapped back as
    DTensors (``o`` placed as ``r``, the state with batch and heads
    placed alike).  Shards of T or n, and partial sums, are gathered
    first: the recurrence runs over all of T and n."""
    mesh = r.device_mesh
    pl = tuple(q if isinstance(q, Shard) and q.dim in (0, 2)
               else Replicate() for q in r.placements)
    r, k, v, w = (t.redistribute(mesh, pl) for t in (r, k, v, w))
    B, T, H, n = r.shape
    rows = local_range(mesh, pl, 0, B)
    heads = local_range(mesh, pl, 2, H)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t
    o, sT = ops.wkv6(*(t.to_local() for t in (r, k, v, w)),
                     full(u)[heads], full(state)[rows, heads],
                     backend=backend)
    s_pl = [Shard(0 if q.dim == 0 else 1) if isinstance(q, Shard) else q
            for q in pl]
    return (DTensor.from_local(o, mesh, pl, run_check=False,
                               shape=r.shape, stride=r.stride()),
            DTensor.from_local(sT, mesh, s_pl, run_check=False,
                               shape=(B, H, n, n),
                               stride=(H * n * n, n * n, n, 1)))


def time_mix_decode(p: Params, x: torch.Tensor, state: torch.Tensor,
                    x_last: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token time-mix.  x: (B, 1, d)."""
    B, _, d = x.shape
    r, k, v, g, w = _streams(p, x, x_last[:, None, :])
    u = p["bonus_u"].to(torch.float32)
    r1, k1, v1, w1 = (t[:, 0].to(torch.float32) for t in (r, k, v, w))
    kv = k1[..., :, None] * v1[..., None, :]
    S = state.to(torch.float32)
    o = local_einsum("bhn,bhnm->bhm", r1, S + u[None, :, :, None] * kv)
    state = w1[..., :, None] * S + kv
    out = (o.reshape(B, 1, d).to(x.dtype) * g) @ p["wo"]
    return out, state, x[:, -1]


def channel_mix(p: Params, x: torch.Tensor, x_last: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV channel-mix (squared-ReLU FFN with receptance gate)."""
    x_prev = torch.cat([x_last[:, None, :], x[:, :-1]], dim=1)
    mix = 0.5 * (x + x_prev)
    kx = torch.square(F.relu(mix @ p["ck"]))
    rx = torch.sigmoid(mix @ p["cr"])
    return rx * (kx @ p["cv"]), x[:, -1]
