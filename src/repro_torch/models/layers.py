"""Building blocks of the model zoo that the ported families need.

Counterparts of the reference package's ``models/layers.py``: the
parameter initialisers, RMSNorm, the embedding lookup, RoPE, the SwiGLU
MLP, GQA attention in its three modes (full sequence, prefill into a
ring-buffer KV cache, one decode token against it) and the encdec
decoder's cross-attention against the encoder's K/V.

Attention is the reference's chunked online softmax in plain torch,
with its order of sums and masks: a q-chunk × kv-chunk loop, the
padded-key mask, ``NEG_INF = -1e30`` (not ``-inf``), the ``l`` floor of
1e-30, and GQA as a ``repeat_interleave`` of K/V over the head axis
(head h uses KV head h // G).  The reference's sharding hints
(:func:`~repro_torch.sharding.context.constrain`, ``axis_size``) stand
where its hints stand; without an installed mesh they return their
input.

``jax.random`` keys become an explicit ``torch.Generator``: the draws
have the reference's distributions but not its numbers, so parity tests
carry the reference's weights across (:mod:`.bridge`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..loops import trip_range
from ..sharding.context import (axis_size, constrain, contiguous_grad,
                                flattenable, local_einsum, local_range,
                                splittable)

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30
HEADS = ("batch", None, "model", None)     # (B, S, H, hd) activations
TOKENS = ("batch", None, None)             # (B, S, d) activations


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_axis(x: torch.Tensor, axis: int, to: int) -> torch.Tensor:
    """``x`` zero-padded at the end of ``axis`` to length ``to``."""
    pad = to - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def dense_init(generator: torch.Generator, shape: Sequence[int], dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1) · scale, with scale 1/sqrt(fan_in) by default (fan_in is
    the second-last axis), drawn in f32 on the generator's device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)           # in place: no second copy


def init_embed(generator: torch.Generator, vocab: int, d_model: int,
               dtype) -> torch.Tensor:
    return dense_init(generator, (vocab, d_model), dtype, scale=0.02)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(dt)


def embed(table: torch.Tensor, tokens) -> torch.Tensor:
    """Rows of ``table`` at ``tokens``, with ``jnp.take``'s semantics:
    an index in [-V, 0) counts from the end, and one outside [-V, V)
    gives a row of NaN (it never raises and never reads out of range).
    A sharded DTensor table is read by :func:`_embed_sharded`."""
    V = table.shape[0]
    idx = torch.as_tensor(tokens, device=table.device)
    if isinstance(table, DTensor) and any(
            type(p) is Shard for p in table.placements + getattr(
                idx, "placements", ())):
        return _embed_sharded(table, idx)
    idx = idx.long()
    idx = torch.where(idx < 0, idx + V, idx)
    ok = (idx >= 0) & (idx < V)
    rows = table[idx.clamp(0, V - 1)]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def _embed_sharded(table: DTensor, idx: torch.Tensor) -> DTensor:
    """:func:`embed` from each rank's shards, without DTensor's gather
    rules (torch 2.11 refuses an index sharded on two mesh dims and the
    gradient of a sharded one).  A mesh dim that shards both the indices
    and the table gathers the table there (FSDP); a vocab shard gives
    its own rows and zeros elsewhere (a partial sum); a shard of d or of
    the indices is kept."""
    mesh = table.device_mesh
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    V = table.shape[0]
    t_pl, out_pl = list(table.placements), []
    for m, (tp, ip) in enumerate(zip(table.placements, idx.placements)):
        if type(ip) is Shard:
            t_pl[m] = Replicate()
            out_pl.append(ip)
        elif type(tp) is Shard:
            out_pl.append(Partial() if tp.dim == 0 else Shard(idx.ndim))
        else:
            out_pl.append(Replicate())
    table = table.redistribute(mesh, t_pl)
    rows = local_range(mesh, t_pl, 0, V)
    i = idx.to_local().long()
    i = torch.where(i < 0, i + V, i)
    ok = (i >= 0) & (i < V)
    mine = (i >= rows.start) & (i < rows.stop)
    local = table.to_local()
    got = local[(i - rows.start).clamp(0, max(local.shape[0] - 1, 0))]
    got = contiguous_grad(got)
    got = torch.where(mine[..., None], got, torch.zeros(
        (), dtype=got.dtype, device=got.device))
    got = torch.where(ok[..., None], got, torch.full(
        (), float("nan"), dtype=got.dtype, device=got.device))
    shape = (*idx.shape, table.shape[1])
    return DTensor.from_local(got, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    exponents = torch.arange(0, hd, 2, dtype=torch.float32,
                             device=x.device) / hd
    freqs = 1.0 / (theta ** exponents)                    # (hd/2,)
    positions = torch.as_tensor(positions, device=x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs  # (B,S,hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (flash-style) attention
# ---------------------------------------------------------------------------
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_offset: int = 0, q_chunk: int = 2048,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """GQA attention without materializing the full score matrix.

    q: (B, Sq, H, hd); k, v: (B, Sk, Kh, hd) with H = Kh * G.
    ``q_offset`` is the absolute position of q[0] relative to k[0].
    ``window > 0`` restricts each query to the last ``window`` keys.
    """
    B, Sq, H, hd = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    Sq_p, Sk_p = round_up(Sq, q_chunk), round_up(Sk, kv_chunk)
    q = pad_axis(q, 1, Sq_p)
    k = pad_axis(k, 1, Sk_p)
    v = pad_axis(v, 1, Sk_p)
    # Attention-chunk layout: shard heads over ``model`` when the head
    # count divides it; otherwise shard the q-chunk (sequence) dim, which
    # keeps the q-block local where an indivisible head count (llava 56,
    # hymba 25, llama4 40 on a 16-way axis) would replicate it.
    m_size = axis_size("model")
    head_sharded = H % m_size == 0 and H >= m_size
    hspec = ("batch", None, "model") if head_sharded \
        else ("batch", "model", None)
    hspec4 = hspec + (None,)
    # Every kv chunk is computed and then masked, so each iteration
    # dispatches the same ops: the dry-run's op counter runs one of each
    # loop for all (trip_range).
    outs = []
    q_trips = trip_range(Sq_p // q_chunk, q)
    for qi in q_trips:
        qb = constrain(q[:, qi * q_chunk:(qi + 1) * q_chunk], hspec4
                       ).to(torch.float32)
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = constrain(torch.zeros((B, q_chunk, H, hd), dtype=torch.float32,
                                    device=dev), hspec4)
        m = constrain(torch.full((B, q_chunk, H), NEG_INF,
                                 dtype=torch.float32, device=dev), hspec)
        l = constrain(torch.zeros((B, q_chunk, H), dtype=torch.float32,
                                  device=dev), hspec)
        for ki in trip_range(Sk_p // kv_chunk, q):
            sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
            # GQA: broadcast Kh -> H (head h uses kv head h // G).
            kb = constrain(k[:, sl].repeat_interleave(G, dim=2),
                           HEADS).to(torch.float32)
            vb = constrain(v[:, sl].repeat_interleave(G, dim=2),
                           HEADS).to(torch.float32)
            kv_idx = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = (kv_idx[None, :] < Sk).expand(q_chunk, kv_chunk)
            if causal:
                mask = mask & (kv_idx[None, :] <= q_pos[:, None])
            if window > 0:
                mask = mask & (kv_idx[None, :] > q_pos[:, None] - window)
            s = local_einsum("bthd,bshd->bths", qb, kb) * scale
            s = torch.where(mask[None, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + local_einsum("bths,bshd->bthd",
                                                        p, vb)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(q_trips.full(outs), dim=1)[:, :Sq]


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             out_scale: float = 1.0) -> Params:
    """``out_scale`` rescales the residual-output projection (GPT-2 style
    1/sqrt(2L)), as in the reference."""
    return {"w_gate": dense_init(generator, (d_model, d_ff), dtype),
            "w_up": dense_init(generator, (d_model, d_ff), dtype),
            "w_down": dense_init(generator, (d_ff, d_model), dtype,
                                 scale=out_scale / math.sqrt(d_ff))}


def spec_mlp(d_model: int, d_ff: int) -> Dict[str, Tuple[int, ...]]:
    return {"w_gate": (d_model, d_ff), "w_up": (d_model, d_ff),
            "w_down": (d_ff, d_model)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = constrain(h, ("batch",) + (None,) * (h.ndim - 2) + ("model",))
    return constrain(h @ p["w_down"], ("batch",) + (None,) * (h.ndim - 1))


# ---------------------------------------------------------------------------
# GQA attention block (params + apply for all three modes)
# ---------------------------------------------------------------------------
def init_attn(generator: torch.Generator, d_model: int, n_heads: int,
              n_kv: int, head_dim: int, dtype, out_scale: float = 1.0
              ) -> Params:
    """The reference's explicit scales: wq/wk/wv contract over axis 0,
    so their fan-in is ``d_model``, not the second-last axis."""
    proj = 1.0 / math.sqrt(d_model)
    return {
        "wq": dense_init(generator, (d_model, n_heads, head_dim), dtype,
                         scale=proj),
        "wk": dense_init(generator, (d_model, n_kv, head_dim), dtype,
                         scale=proj),
        "wv": dense_init(generator, (d_model, n_kv, head_dim), dtype,
                         scale=proj),
        "wo": dense_init(generator, (n_heads, head_dim, d_model), dtype,
                         scale=out_scale / math.sqrt(n_heads * head_dim)),
    }


def spec_attn(d_model: int, n_heads: int, n_kv: int, head_dim: int
              ) -> Dict[str, Tuple[int, ...]]:
    return {"wq": (d_model, n_heads, head_dim),
            "wk": (d_model, n_kv, head_dim),
            "wv": (d_model, n_kv, head_dim),
            "wo": (n_heads, head_dim, d_model)}


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    h = w.shape[1]
    w2 = splittable(w.reshape(w.shape[0], -1), -1, h)
    return splittable(x @ w2, -1, h).unflatten(-1, w.shape[1:])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, wo) as one matmul."""
    h = o.shape[-2]
    return (splittable(flattenable(o, -2, -1).flatten(-2), -1, h)
            @ splittable(wo.reshape(-1, wo.shape[-1]), 0, h))


def _qkv(p: Params, x: torch.Tensor, positions, theta: float):
    """RoPE'd q and k, and v, of a full sequence, each pinned to heads."""
    q = apply_rope(constrain(_heads(x, p["wq"]), HEADS), positions, theta)
    k = apply_rope(constrain(_heads(x, p["wk"]), HEADS), positions, theta)
    return q, k, constrain(_heads(x, p["wv"]), HEADS)


def self_attention(p: Params, x: torch.Tensor, *, theta: float,
                   causal: bool = True, window: int = 0,
                   positions=None) -> torch.Tensor:
    """Full-sequence attention (training / forward)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(p, x, positions, theta)
    o = chunked_attention(q, k, v, causal=causal, window=window)
    return constrain(_out(o, p["wo"]), TOKENS)


def cross_attention(p: Params, x: torch.Tensor, memory_k: torch.Tensor,
                    memory_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (no RoPE,
    no mask)."""
    o = chunked_attention(constrain(_heads(x, p["wq"]), HEADS), memory_k,
                          memory_v, causal=False)
    return constrain(_out(o, p["wo"]), TOKENS)


def memory_kv(p: Params, memory: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory (B, S_enc, d) as cross-attention K and V
    (B, S_enc, Kh, hd), without RoPE."""
    return _heads(memory, p["wk"]), _heads(memory, p["wv"])


def prefill_attention(p: Params, x: torch.Tensor, cache_window: int, *,
                      theta: float, window: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill: full causal attention AND the ring-buffer KV cache
    covering the last ``cache_window`` positions."""
    q, k, v = _qkv(p, x, torch.arange(x.shape[1], device=x.device), theta)
    o = chunked_attention(q, k, v, causal=True, window=window)
    return (constrain(_out(o, p["wo"]), TOKENS),
            ring_from_prefill(k, cache_window),
            ring_from_prefill(v, cache_window))


def ring_from_prefill(kv: torch.Tensor, W: int) -> torch.Tensor:
    """The last ``W`` positions of a (B, S, Kh, hd) tensor in ring order:
    slot i holds position p with p ≡ i (mod W)."""
    S = kv.shape[1]
    if S <= W:
        return pad_axis(kv, 1, W)
    # Position S-W+j goes to slot (S-W+j) mod W; the roll does that.
    tail, r = kv[:, S - W:], (S - W) % W
    if isinstance(kv, DTensor):           # torch 2.11 has no DTensor roll
        return torch.cat([tail[:, W - r:], tail[:, :W - r]], dim=1)
    return torch.roll(tail, shifts=r, dims=1)


def decode_attention(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, theta: float,
                     window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode against a ring-buffer KV cache.

    x: (B, 1, d).  k_cache/v_cache: (B, W, Kh, hd).  ``cache_len`` is the
    number of tokens already in history (= absolute position of x), a
    scalar shared by every row or a ``(B,)`` vector of per-row clocks.
    Slot i holds absolute position p = cache_len - ((cache_len - i) mod
    W).  The reference's scalar branch computes what its per-row branch
    computes with every row's clock equal, so a scalar is broadcast to
    ``(B,)`` here.  Returns (out, new k_cache, new v_cache); the given
    caches are not changed.
    """
    B, W = x.shape[0], k_cache.shape[1]
    hd = p["wq"].shape[-1]
    cl = torch.as_tensor(cache_len, device=x.device).to(torch.int64)
    cl = cl.expand(B) if cl.ndim == 0 else cl
    q = apply_rope(_heads(x, p["wq"]), cl[:, None], theta)
    k = apply_rope(_heads(x, p["wk"]), cl[:, None], theta)
    v = _heads(x, p["wv"])
    rows = torch.arange(B, device=x.device)
    slot = torch.remainder(cl, W)
    k_cache = k_cache.index_put((rows, slot), k[:, 0].to(k_cache.dtype))
    v_cache = v_cache.index_put((rows, slot), v[:, 0].to(v_cache.dtype))
    idx = torch.arange(W, device=x.device)
    # A floor modulo, as jnp.mod: cl - idx is negative for slots ahead
    # of the clock.
    abs_pos = cl[:, None] - torch.remainder(cl[:, None] - idx[None, :], W)
    valid = abs_pos >= 0                                 # (B, W)
    if window > 0:
        valid = valid & (abs_pos > cl[:, None] - window)
    Kh = k_cache.shape[2]
    G = q.shape[2] // Kh
    qf = splittable(q, 2, Kh).reshape(B, 1, Kh, G, hd).to(torch.float32)
    s = local_einsum("btkgh,bskh->btkgs", qf,
                     k_cache.to(torch.float32)) / math.sqrt(hd)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = local_einsum("btkgs,bskh->btkgh", w,
                     v_cache.to(torch.float32)).to(x.dtype)
    return (_out(flattenable(o, 2, 3).reshape(B, 1, q.shape[2], hd),
                 p["wo"]), k_cache, v_cache)
