"""Plain PyTorch versions of the port's kernels: the fused node
filter+score pass and the RWKV-6 WKV recurrence.

Node scores match :func:`repro_torch.core.scoring.node_scores_np` bit for
bit: f32 throughout, weights rounded once to f32, ``used / g`` (a true
division, not a multiply by ``1/g``), and numpy's evaluation order
``((w_u·(used/g) + w_f·fit) + w_g·gload) + w_t·topo``.  Each operand that
is not a node column is a 0-d tensor on the columns' device: CUDA
divides by a *CPU scalar* as a multiply by its reciprocal, which would
break bit-equality at g = 6.  Each op is its own launch, so nothing is
contracted into an FMA.  These run on CPU or CUDA tensors; the CUDA
kernels in :mod:`repro_torch.kernels.node_score` and
:mod:`repro_torch.kernels.wkv6` are held against them.
"""

from __future__ import annotations

import torch

from ..device import NEG_INF
from ..loops import trip_range


def node_scores_ref(free: torch.Tensor, used: torch.Tensor,
                    mask: torch.Tensor, group_load: torch.Tensor,
                    topo_pref: torch.Tensor, *, request: int,
                    gpus_per_node: int, w_used: float, w_fit: float,
                    w_group: float, w_topo: float) -> torch.Tensor:
    """Score every node, ``NEG_INF`` where invalid.

    Args:
      free:       (n,) int — healthy free devices per node.
      used:       (n,) int — healthy allocated devices per node.
      mask:       (n,) bool/int — node is in the candidate pool.
      group_load: (n,) f32 — load fraction of the node's NodeNetGroup,
                  pre-gathered to node axis.
      topo_pref:  (n,) f32 — anchor-group preference for this job.
    """
    dev = free.device

    def f32(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    free_f = free.to(torch.float32)
    used_f = used.to(torch.float32)
    req = f32(float(request))
    valid = (mask != 0) & (free_f >= req)
    exact = (free_f == req).to(torch.float32)
    score = f32(w_used) * (used_f / f32(float(gpus_per_node)))
    score = score + f32(w_fit) * exact
    score = score + f32(w_group) * group_load.to(torch.float32)
    score = score + f32(w_topo) * topo_pref.to(torch.float32)
    return torch.where(valid, score, f32(NEG_INF))


def node_scores_slots_ref(free: torch.Tensor, used: torch.Tensor,
                          mask: torch.Tensor, group_load: torch.Tensor,
                          topo_pref: torch.Tensor, *, request: int,
                          gpus_per_node: int, w_used: float, w_fit: float,
                          w_group: float, w_topo: float):
    """Fused (scores, pod_slots): slots = ``free // request`` where
    valid, else 0 (int32)."""
    scores = node_scores_ref(free, used, mask, group_load, topo_pref,
                             request=request, gpus_per_node=gpus_per_node,
                             w_used=w_used, w_fit=w_fit, w_group=w_group,
                             w_topo=w_topo)
    free_i = free.to(torch.int32)
    valid = (mask != 0) & (free_i >= request)
    slots = torch.where(valid, torch.div(free_i, request,
                                         rounding_mode="floor"),
                        torch.zeros_like(free_i))
    return scores, slots.to(torch.int32)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """Plain step loop of the RWKV-6 WKV recurrence, the same maths as
    the reference's ``kernels/ref.py::wkv6_ref``.

    r, k, v, w: (B, T, H, n); u: (H, n); s0: (B, H, n, n).  Every input
    is upcast to f32.  Returns (o (B, T, H, n) f32, S_T (B, H, n, n)
    f32), with ``o_t = einsum(r_t, S + u·k_tᵀv_t)`` in that order and
    ``S <- w_t[:, None]·S + k_tᵀv_t``.  Runs on the inputs' device; the
    CUDA kernel in :mod:`repro_torch.kernels.wkv6` is held against it.
    Under the dry-run's op counter on meta tensors the loop runs one
    step, counted T times (:func:`~repro_torch.loops.trip_range`).
    """
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    u = u.to(torch.float32)[None, :, :, None]
    S = s0.to(torch.float32)
    outs = []
    steps = trip_range(r.shape[1], r)
    for t in steps:
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]    # (B, H, n, n)
        outs.append(torch.einsum("bhn,bhnm->bhm", r[:, t], S + u * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(steps.full(outs), dim=1), S


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                     chunk: int = 16):
    """The chunked kernels' algorithm (``csrc/wkv6.cu``) in plain torch,
    step for step: the same values as :func:`wkv6_ref` by another route.

    T is cut into chunks of ``chunk`` steps (a power of two); the ragged
    last chunk is padded with r = k = v = 0 and w = 1, which leaves the
    state as it is.  Per chunk, with D(x, y) the product of w_j over
    x <= j < y (1 when empty, never a log or an exp):

      o_t   = (r_t·D(t0, t)) @ S_in + Σ_{s<t} A[t, s] v_s + (r_t·u·k_t) v_t
      S_out = D(t0, t0+C)[:, None]·S_in + Σ_s (k_s·D(s+1, t0+C))ᵀ v_s

    with A[t, s] = Σ_i r_t[i] k_s[i] D(s+1, t)[i] split at the start R of
    the upper half of the smallest aligned block holding s and t (level
    L = the top bit of t xor s): (r_t·D(R, t)) · (k_s·D(s+1, R)), both
    factors in [0, 1].  The products run in the kernel's order.  Returns
    (o (B, T, H, n) f32, S_T (B, H, n, n) f32) on the inputs' device.
    """
    if chunk < 1 or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two, got {chunk}")
    r, k, v, w = (t.to(torch.float32) for t in (r, k, v, w))
    B, T, H, n = r.shape
    C = chunk
    n_chunks = -(-T // C)
    pad = n_chunks * C - T

    def blocks(x, fill):
        if pad:
            x = torch.cat([x, x.new_full((B, pad, H, n), fill)], dim=1)
        return x.reshape(B, n_chunks, C, H, n).permute(0, 3, 1, 2, 4)

    # (B, H, n_chunks, C, n)
    r, k, v = (blocks(x, 0.0) for x in (r, k, v))
    w = blocks(w, 1.0)
    levels = C.bit_length() - 1
    rf, kb = [r], [k]                 # level 0: no scaling
    wtot = w[..., 0, :]
    for lvl in range(1, levels + 1):
        span = 1 << lvl
        ws = w.reshape(B, H, n_chunks, C // span, span, n)
        fwd, bwd = torch.empty_like(ws), torch.empty_like(ws)
        p = torch.ones_like(ws[..., 0, :])
        for j in range(span):
            fwd[..., j, :] = p
            p = p * ws[..., j, :]
        if lvl == levels:
            wtot = p[..., 0, :]       # D(t0, t0 + C)
        p = torch.ones_like(p)
        for j in reversed(range(span)):
            bwd[..., j, :] = p
            p = p * ws[..., j, :]
        rf.append(r * fwd.reshape(r.shape))
        kb.append(k * bwd.reshape(k.shape))

    idx = torch.arange(C, device=r.device)
    xor = idx[:, None] ^ idx[None, :]
    lower = idx[None, :] < idx[:, None]                 # s < t
    A = torch.zeros(B, H, n_chunks, C, C, device=r.device)
    for lvl in range(levels):
        mask = lower & (xor >= (1 << lvl)) & (xor < (2 << lvl))
        A = A + torch.where(mask, rf[lvl] @ kb[lvl].transpose(-1, -2), 0.0)
    bonus = ((r * u.to(torch.float32)[None, :, None, None, :]) * k).sum(-1)
    A = A + torch.diag_embed(bonus)

    S = s0.to(torch.float32)
    outs = []
    for c in range(n_chunks):
        outs.append(rf[levels][:, :, c] @ S + A[:, :, c] @ v[:, :, c])
        S = wtot[:, :, c, :, None] * S \
            + kb[levels][:, :, c].transpose(-1, -2) @ v[:, :, c]
    o = torch.stack(outs, dim=2)                        # (B, H, nc, C, n)
    o = o.permute(0, 2, 3, 1, 4).reshape(B, n_chunks * C, H, n)[:, :T]
    return o.contiguous(), S
