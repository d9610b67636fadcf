"""Mixture-of-Experts FFN with GShard-style grouped capacity dispatch.

The counterpart of the reference package's ``models/moe.py``.  Tokens
are dispatched **per batch row** (the GShard "group" axis): each row
takes its own router top-k, position-in-expert exclusive cumsum and
capacity ``C = cf·S·k/E`` (a multiple of 4, at least 4).  Assignments
past an expert's capacity in their row go to the trash slot ``E·C`` and
are dropped; the Switch auxiliary load-balance loss is returned beside
the output.

The order of the reference is kept where it decides an answer:

* ``lax.top_k`` takes the lower expert first among equal probabilities.
  ``torch.topk`` documents no tie order, so :func:`route` takes the
  first ``k`` of a stable descending sort, as
  ``kernels/ops.py::gang_slot_prefilter`` does for the scheduler;
* ``dispatch="sort"`` groups assignments by a stable argsort of their
  expert, ``"scatter"`` adds them into the ``(B, E·C + 1, d)`` buffer;
  both build the same ``(B, E, C, d)`` expert buffer;
* the router product is f32 and the combine runs in ``x.dtype`` with the
  gates masked by ``keep``.

The expert SwiGLU runs as ``torch.bmm`` over the contiguous ``E`` axis
of the ``(E, d, f)`` weights, so no weight is copied: only the small
``(E, B·C, d)`` activations are rearranged.  Every expert's weights are
read whatever the routing, as in the reference.  The reference's
sharding hints pin the expert buffer, the expert outputs and the combine
as its hints do; its hint on the hidden ``(B, E, C, f)`` activations
pins the port's ``(E, B·C, f)`` layout of them to experts over
``model``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..sharding.context import constrain
from .layers import Params, dense_init

DISPATCH = ("sort", "scatter")


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, dtype, out_scale: float = 1.0) -> Params:
    """The router and the stacked expert SwiGLU weights, drawn on
    ``generator``'s device in the reference's distributions."""
    E = n_experts
    return {
        "router": dense_init(generator, (d_model, E), dtype),
        "w_gate": dense_init(generator, (E, d_model, d_ff), dtype),
        "w_up": dense_init(generator, (E, d_model, d_ff), dtype),
        "w_down": dense_init(generator, (E, d_ff, d_model), dtype,
                             scale=out_scale / math.sqrt(d_ff)),
    }


def spec_moe(d_model: int, d_ff: int, n_experts: int
             ) -> Dict[str, Tuple[int, ...]]:
    E = n_experts
    return {"router": (d_model, E), "w_gate": (E, d_model, d_ff),
            "w_up": (E, d_model, d_ff), "w_down": (E, d_ff, d_model)}


def capacity(tokens_per_group: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = int(capacity_factor * tokens_per_group * top_k / n_experts)
    return max(4, -(-c // 4) * 4)               # multiple of 4, >= 4


def route(p: Params, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (probs (B, S, E) f32, renormalised gates (B, S, k)
    f32, expert ids (B, S, k)); the lower expert first on ties."""
    logits = x.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = top.values[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, top.indices[..., :top_k]


def expert_buffer(x: torch.Tensor, flat_expert: torch.Tensor,
                  onehot: torch.Tensor, slot: torch.Tensor, top_k: int,
                  C: int, dispatch: str) -> torch.Tensor:
    """The (B, E, C, d) expert buffer: slot ``e·C + c`` holds the c-th
    assignment of its row to expert e (zero where there is none)."""
    B, S, d = x.shape
    E = onehot.shape[-1]
    dev = x.device
    if dispatch == "sort":
        N = S * top_k
        counts = onehot.sum(dim=1)                            # (B, E)
        starts = torch.cumsum(counts, dim=1) - counts         # exclusive
        order = torch.argsort(flat_expert, dim=1, stable=True)  # (B, N)
        # sorted rank start[e] + c  ->  assignment id  ->  token id.
        c_idx = torch.arange(C, device=dev)
        grid = starts[:, :, None] + c_idx[None, None, :]
        valid = c_idx[None, None, :] < torch.clamp(counts,
                                                   max=C)[:, :, None]
        assign = torch.gather(
            order, 1, torch.clamp(grid, 0, N - 1).reshape(B, E * C))
        token = assign // top_k                               # (B, E*C)
        gathered = torch.gather(x, 1, token[..., None].expand(B, E * C, d))
        return gathered.reshape(B, E, C, d) * valid[..., None].to(x.dtype)
    # Row-local scatter into (B, E*C+1, d); trash absorbs overflow.
    xa = x.repeat_interleave(top_k, dim=1)                    # (B, S*k, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=x.dtype, device=dev)
    buf.scatter_add_(1, slot[..., None].expand(B, S * top_k, d), xa)
    return buf[:, :E * C].reshape(B, E, C, d)


def experts(p: Params, expert_in: torch.Tensor) -> torch.Tensor:
    """The batched expert SwiGLU, (B, E, C, d) -> (B, E, C, d): one
    ``bmm`` per weight over its contiguous E axis."""
    B, E, C, d = expert_in.shape
    xe = expert_in.transpose(0, 1).reshape(E, B * C, d)
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    h = constrain(h, ("model", None, None))
    out = torch.bmm(h, p["w_down"])                           # (E, B*C, d)
    return out.reshape(E, B, C, d).transpose(0, 1)


def moe_ffn(p: Params, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, dispatch: str = "sort"
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux load-balance loss scalar).

    ``dispatch``: ``"sort"`` (the default, scatter-free) or
    ``"scatter"`` (the reference's baseline); both give the same
    buffer."""
    if dispatch not in DISPATCH:
        raise ValueError(f"unknown dispatch {dispatch!r}; expected "
                         f"{DISPATCH}")
    B, S, d = x.shape
    E = p["router"].shape[-1]
    C = capacity(S, E, top_k, capacity_factor)

    probs, gate_vals, expert_ids = route(p, x, top_k)
    # Per-row position of each (token, k) assignment in its expert queue.
    flat_expert = expert_ids.reshape(B, S * top_k)            # (B, S*k)
    onehot = F.one_hot(flat_expert, E)                        # (B, S*k, E)
    pos_in_expert = torch.cumsum(onehot, dim=1) - onehot      # exclusive
    pos = torch.gather(pos_in_expert, 2, flat_expert[..., None])[..., 0]
    keep = pos < C
    slot = torch.where(keep, flat_expert * C + pos,
                       torch.full_like(pos, E * C))           # E*C = trash

    expert_in = constrain(expert_buffer(x, flat_expert, onehot, slot,
                                        top_k, C, dispatch),
                          ("batch", "model", None, None))
    expert_out = constrain(experts(p, expert_in),
                           ("batch", "model", None, None))

    # Row-local gather back, weighted by the (renormalised) gates, in
    # x.dtype; the k assignments of a token are adjacent, so the combine
    # is a reshape-sum over k.
    flat_out = torch.cat([expert_out.reshape(B, E * C, d),
                          expert_out.new_zeros((B, 1, d))], dim=1)
    per_assign = torch.gather(flat_out, 1,
                              slot[..., None].expand(B, S * top_k, d))
    gates = (gate_vals.reshape(B, S * top_k)[..., None]
             * keep[..., None].to(torch.float32)).to(x.dtype)
    out = constrain((per_assign * gates).reshape(B, S, top_k, d).sum(dim=2),
                    ("batch", None, None))

    # Switch-style auxiliary load-balance loss.
    me = probs.mean(dim=(0, 1))                               # (E,)
    ce = onehot.sum(dim=(0, 1)).to(torch.float32) / (B * S * top_k)
    aux = E * torch.sum(me * ce)
    return out.to(x.dtype), aux
