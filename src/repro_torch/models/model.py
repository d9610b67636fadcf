"""The model zoo: ``ArchConfig`` -> init / forward / prefill / decode.

The counterpart of the reference package's ``models/model.py`` for
every family of the zoo: ``dense`` (RoPE, GQA attention, SwiGLU MLP),
``ssm`` (RWKV-6), ``moe`` (the dense block with a GShard MoE FFN,
:mod:`.moe`), ``hybrid`` (Hymba: parallel attention and selective-SSM
heads, :mod:`.hymba`), ``encdec`` (a bidirectional encoder over stub
frame embeddings, and a decoder block with cross-attention after its
self-attention) and ``vlm`` (stub patch embeddings spliced in front of
the text tokens; only the text positions score).  The stubs are
:mod:`.frontend`'s.

Where the reference stacks per-layer parameters along a leading ``L``
axis and scans over them with ``lax.scan``, the port keeps one
``nn.ParameterDict`` per layer (nested where the reference's block is:
``attn``, ``mlp``, ``moe`` and ``ssm``) in an ``nn.ModuleList`` and
loops in Python.  Parameter names are the reference's keys (``embed``,
``layers.<l>.<key>``, ``layers.<l>.attn.wq``, ``encoder.<l>.<key>``,
``enc_norm``, ``final_norm``, ``lm_head``), so
:func:`repro_torch.models.bridge.params_from_reference` carries its
weights across.  The cache keeps the reference's layout and keys: a
ring-buffer KV cache ``layers.k`` and ``layers.v`` ``(L,B,W,Kh,hd)`` for
every family with attention, and for ``hybrid`` also the SSM state
``layers.ssm (L,B,d,N) f32``; for ``ssm`` ``layers.state (L,B,H,n,n)
f32``, ``layers.x_last_t`` and ``x_last_c`` ``(L,B,d)``; for ``encdec``
the cross-attention's K/V of the encoder memory, ``memory.mk`` and
``memory.mv`` ``(L,B,S_enc,Kh,hd)``, which decode reads and never
changes; and the clock ``t`` (a scalar, or ``(B,)`` per-row clocks as
the serving engine keeps; for ``vlm`` it counts the patch prefix).

Parameters are built with ``requires_grad=False``: serving needs no
graph.  A train step (:mod:`repro_torch.train.step`) turns gradients on
for the parameters it trains; ``forward`` then builds a graph, with each
decoder block under ``torch.utils.checkpoint`` when ``remat=True`` (the
reference's ``jax.checkpoint`` of its scan body).  ``prefill`` and
``decode_step`` run under ``no_grad``.

A ``Model`` is built on the meta device, so it holds no memory until
:meth:`Model.init` draws its weights or ``load_state_dict(...,
assign=True)`` takes them.  Its spec twins, :meth:`Model.param_specs`
(stacked, as the reference's) and :meth:`Model.cache_specs`, give the
shapes and types as meta tensors.

The reference's sharding hints (``constrain``) stand where its hints
stand; they return their input unless a mesh is installed with
:func:`repro_torch.sharding.context.use_activation_sharding`.  Under a
mesh, with the parameters distributed by
:func:`repro_torch.sharding.auto.distribute_state_dict`, every family
runs on DTensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..sharding.context import constrain
from . import hymba as hy
from . import moe as moe_mod
from . import rwkv6 as rw
from .layers import (cross_attention, decode_attention, dense_init, embed,
                     init_attn, init_embed, init_mlp, memory_kv, mlp,
                     prefill_attention, rmsnorm, self_attention, spec_attn,
                     spec_mlp)

PyTree = Any
WKV_BACKENDS = rw.TIME_MIX_BACKENDS
FAMILIES = ("dense", "ssm", "moe", "hybrid", "encdec", "vlm")


def _residual_out_scale(n_layers: int) -> float:
    """GPT-2/Megatron depth scaling for residual-output projections."""
    return 1.0 / math.sqrt(max(1, 2 * n_layers))


def _meta(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


def _meta_tree(shapes: Dict[str, Any]) -> nn.ParameterDict:
    """A (nested) dict of shapes as a (nested) ParameterDict on meta."""
    return nn.ParameterDict({
        k: _meta_tree(s) if isinstance(s, dict) else _meta(*s)
        for k, s in shapes.items()})


def _param(t: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(t.to(device), requires_grad=False)


def _assign(lp: nn.ParameterDict, block: Dict[str, Any], device) -> None:
    """Put a (nested) dict of tensors into a (nested) ParameterDict.  A
    module-level function: a recursive closure over the model would hold
    the model in a reference cycle, and so its memory until the cyclic
    collector runs."""
    for k, t in block.items():
        if isinstance(t, dict):
            _assign(lp[k], t, device)
        else:
            lp[k] = _param(t, device)


def _tree_map(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    """A (nested) dict with ``fn`` applied to each leaf."""
    return {k: _tree_map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _block_shapes(cfg: ArchConfig, head_dim: int) -> Dict[str, Any]:
    """One block's parameter shapes, keyed as the reference's block."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "ssm":
        return rw.spec_rwkv_block(d, f, head_dim)
    p: Dict[str, Any] = {"norm1": (d,), "norm2": (d,)}
    if cfg.family == "hybrid":
        p.update(hy.spec_hymba_block(d, cfg.n_heads, cfg.n_kv_heads,
                                     head_dim, cfg.ssm_state))
    else:
        p["attn"] = spec_attn(d, cfg.n_heads, cfg.n_kv_heads, head_dim)
    if cfg.family == "moe":
        p["moe"] = moe_mod.spec_moe(d, f, cfg.n_experts)
    else:
        p["mlp"] = spec_mlp(d, f)
    if cfg.family == "encdec":
        p["norm_x"] = (d,)
        p["xattn"] = spec_attn(d, cfg.n_heads, cfg.n_kv_heads, head_dim)
    return p


def _enc_block_shapes(cfg: ArchConfig, head_dim: int) -> Dict[str, Any]:
    """One encoder block's parameter shapes (a dense block)."""
    d = cfg.d_model
    return {"norm1": (d,), "norm2": (d,),
            "attn": spec_attn(d, cfg.n_heads, cfg.n_kv_heads, head_dim),
            "mlp": spec_mlp(d, cfg.d_ff)}


class Model(nn.Module):
    """One model of the zoo on one device.

    ``device=None`` is CUDA (raises without it); pass ``"cpu"`` to run
    on the host.  ``wkv_backend`` ("kernel" or "scan") is the
    ``time_mix`` backend of every layer on the full-sequence path.
    """

    def __init__(self, cfg: ArchConfig, *, device=None,
                 wkv_backend: str = "kernel") -> None:
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; expected "
                             f"{FAMILIES}")
        if wkv_backend not in WKV_BACKENDS:
            raise ValueError(f"unknown wkv_backend {wkv_backend!r}; "
                             f"expected {WKV_BACKENDS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.wkv_backend = wkv_backend
        self.head_dim = cfg.head_dim or 64
        d, V = cfg.d_model, cfg.vocab
        shapes = _block_shapes(cfg, self.head_dim)
        self.embed = _meta(V, d)
        self.layers = nn.ModuleList(_meta_tree(shapes)
                                    for _ in range(cfg.n_layers))
        if cfg.n_enc_layers:
            enc = _enc_block_shapes(cfg, self.head_dim)
            self.encoder = nn.ModuleList(_meta_tree(enc)
                                         for _ in range(cfg.n_enc_layers))
            self.enc_norm = _meta(d)
        self.final_norm = _meta(d)
        self.lm_head = _meta(d, V)

    # -- parameters -----------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32
             ) -> "Model":
        """Draw every weight from ``generator`` (in the reference's
        distributions, not its numbers) in ``dtype``; returns self."""
        cfg, dev = self.cfg, self.device
        self.embed = _param(init_embed(generator, cfg.vocab, cfg.d_model,
                                       dtype), dev)
        for lp in self.layers:
            _assign(lp, self._init_block(generator, dtype), dev)
        if cfg.n_enc_layers:
            d, hd = cfg.d_model, self.head_dim
            rs = _residual_out_scale(cfg.n_enc_layers)
            for lp in self.encoder:
                _assign(lp, {
                    "norm1": torch.ones(d, dtype=dtype),
                    "norm2": torch.ones(d, dtype=dtype),
                    "attn": init_attn(generator, d, cfg.n_heads,
                                      cfg.n_kv_heads, hd, dtype,
                                      out_scale=rs),
                    "mlp": init_mlp(generator, d, cfg.d_ff, dtype,
                                    out_scale=rs)}, dev)
            self.enc_norm = _param(torch.ones(d, dtype=dtype), dev)
        self.final_norm = _param(torch.ones(cfg.d_model, dtype=dtype), dev)
        self.lm_head = _param(dense_init(generator, (cfg.d_model, cfg.vocab),
                                         dtype, scale=0.02), dev)
        return self

    def _init_block(self, generator: torch.Generator, dtype
                    ) -> Dict[str, Any]:
        cfg = self.cfg
        d, f, hd = cfg.d_model, cfg.d_ff, self.head_dim
        rs = _residual_out_scale(cfg.n_layers)
        if cfg.family == "ssm":
            return rw.init_rwkv_block(generator, d, f, hd, dtype,
                                      out_scale=rs)
        p: Dict[str, Any] = {"norm1": torch.ones(d, dtype=dtype),
                             "norm2": torch.ones(d, dtype=dtype)}
        if cfg.family == "hybrid":
            p.update(hy.init_hymba_block(generator, d, cfg.n_heads,
                                         cfg.n_kv_heads, hd, cfg.ssm_state,
                                         dtype, out_scale=rs))
        else:
            p["attn"] = init_attn(generator, d, cfg.n_heads, cfg.n_kv_heads,
                                  hd, dtype, out_scale=rs)
        if cfg.family == "moe":
            p["moe"] = moe_mod.init_moe(generator, d, f, cfg.n_experts,
                                        dtype, out_scale=rs)
        else:
            p["mlp"] = init_mlp(generator, d, f, dtype, out_scale=rs)
        if cfg.family == "encdec":
            p["norm_x"] = torch.ones(d, dtype=dtype)
            p["xattn"] = init_attn(generator, d, cfg.n_heads,
                                   cfg.n_kv_heads, hd, dtype, out_scale=rs)
        return p

    def param_specs(self, dtype=torch.bfloat16) -> PyTree:
        """The parameters as tensors on the meta device, stacked as the
        reference's ``param_specs`` stacks them (``layers`` and
        ``encoder`` leaves carry a leading layer axis), all in
        ``dtype``."""
        cfg = self.cfg
        d, V = cfg.d_model, cfg.vocab

        def meta(shape, n=None):
            return torch.empty(shape if n is None else (n, *shape),
                               dtype=dtype, device="meta")

        specs = {"embed": meta((V, d)),
                 "layers": _tree_map(_block_shapes(cfg, self.head_dim),
                                     lambda s: meta(s, cfg.n_layers)),
                 "final_norm": meta((d,)), "lm_head": meta((d, V))}
        if cfg.n_enc_layers:
            specs["encoder"] = _tree_map(
                _enc_block_shapes(cfg, self.head_dim),
                lambda s: meta(s, cfg.n_enc_layers))
            specs["enc_norm"] = meta((d,))
        return specs

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def n_active_params(self) -> int:
        """MoE: count top_k of n_experts expert params; else n_params."""
        cfg = self.cfg
        total = self.n_params()
        if cfg.family != "moe":
            return total
        expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_layers
        return total - expert * (cfg.n_experts - cfg.top_k)

    # -- input assembly ---------------------------------------------------
    def _input_seq(self, batch: Dict[str, Any]) -> torch.Tensor:
        """Token embeddings, with the vlm patch prefix spliced in front."""
        x = embed(self.embed, batch["tokens"])
        if self.cfg.family == "vlm":
            x = torch.cat([batch["patch_embeds"].to(x.device, x.dtype), x],
                          dim=1)
        return constrain(x, ("batch", "seq", None))

    def _encode(self, enc_embeds: torch.Tensor) -> torch.Tensor:
        """The encoder stack over the frame embeddings (bidirectional
        self-attention with RoPE, then the MLP), under ``enc_norm``."""
        cfg = self.cfg
        eps = cfg.norm_eps
        x = enc_embeds.to(self.embed.device, self.embed.dtype)
        for lp in self.encoder:
            x = x + self_attention(lp["attn"], rmsnorm(x, lp["norm1"], eps),
                                   theta=cfg.rope_theta, causal=False)
            x = x + mlp(lp["mlp"], rmsnorm(x, lp["norm2"], eps))
        return rmsnorm(x, self.enc_norm, eps)

    # -- full-sequence pass -------------------------------------------------
    def _seq_block(self, lp, x: torch.Tensor, memory: Optional[torch.Tensor],
                   cache_window: int, emit_cache: bool
                   ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                              Optional[torch.Tensor]]:
        """One block over the full sequence; returns (x, cache entry or
        None, aux loss or None).  An encdec entry also holds the
        cross-attention's memory K/V, ``mk`` and ``mv``."""
        cfg = self.cfg
        eps = cfg.norm_eps
        if cfg.family == "ssm":
            st0 = torch.zeros(rw.rwkv_state_shape(x.shape[0], cfg.d_model,
                                                  self.head_dim),
                              dtype=torch.float32, device=x.device)
            xt = rmsnorm(x, lp["ln_t"], eps)
            t_out, st, xl_t = rw.time_mix(lp, xt, st0,
                                          torch.zeros_like(xt[:, 0]),
                                          backend=self.wkv_backend)
            x = x + t_out
            xc = rmsnorm(x, lp["ln_c"], eps)
            c_out, xl_c = rw.channel_mix(lp, xc, torch.zeros_like(xc[:, 0]))
            x = x + c_out
            return x, ({"state": st, "x_last_t": xl_t, "x_last_c": xl_c}
                       if emit_cache else None), None
        h_in = rmsnorm(x, lp["norm1"], eps)
        entry = None
        if emit_cache:
            a_out, k_c, v_c = prefill_attention(
                lp["attn"], h_in, cache_window, theta=cfg.rope_theta,
                window=cfg.window)
            entry = {"k": k_c, "v": v_c}
        else:
            a_out = self_attention(lp["attn"], h_in, theta=cfg.rope_theta,
                                   window=cfg.window)
        if cfg.family == "hybrid":
            h0 = torch.zeros(hy.ssm_state_shape(x.shape[0], cfg.d_model,
                                                cfg.ssm_state),
                             dtype=torch.float32, device=x.device)
            s_out, h_ssm = hy.ssm_scan(lp["ssm"], h_in, h0)
            x = self._mix_heads(lp, x, a_out, s_out)
            if emit_cache:
                entry["ssm"] = h_ssm
        else:
            x = x + a_out
        if cfg.family == "encdec":
            mk, mv = memory_kv(lp["xattn"], memory)
            xm = rmsnorm(x, lp["norm_x"], eps)
            x = x + cross_attention(lp["xattn"], xm, mk, mv)
            if emit_cache:
                entry.update(mk=mk, mv=mv)
        x, aux = self._ffn(lp, x)
        return x, entry, aux

    def _mix_heads(self, lp, x: torch.Tensor, a_out: torch.Tensor,
                   s_out: torch.Tensor) -> torch.Tensor:
        """The hybrid block's residual: the mean of the separately
        normalised attention and SSM heads."""
        eps = self.cfg.norm_eps
        a_out = rmsnorm(a_out, lp["norm_attn_out"], eps)
        s_out = rmsnorm(s_out, lp["norm_ssm_out"], eps)
        return x + 0.5 * (a_out + s_out)

    def _ffn(self, lp, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block's FFN residual (the MoE's or the MLP's) and its aux
        loss (None but for moe)."""
        cfg = self.cfg
        h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
        if cfg.family == "moe":
            m_out, aux = moe_mod.moe_ffn(lp["moe"], h2, top_k=cfg.top_k,
                                         capacity_factor=cfg.capacity_factor)
            return x + m_out, aux
        return x + mlp(lp["mlp"], h2), None

    def _run_layers(self, x: torch.Tensor, memory: Optional[torch.Tensor],
                    cache_window: int, emit_cache: bool, remat: bool = False
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]],
                               torch.Tensor]:
        """Every block in turn; returns (x, the stacked cache or None,
        the aux loss summed over the layers).  ``remat``: each block runs
        under ``torch.utils.checkpoint``, which keeps only its input and
        recomputes the rest in the backward pass."""
        entries = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in self.layers:
            x = constrain(x, ("batch", "seq", None))
            args = (lp, x, memory, cache_window, emit_cache)
            if remat:
                x, entry, a = checkpoint(self._seq_block, *args,
                                         use_reentrant=False)
            else:
                x, entry, a = self._seq_block(*args)
            x = constrain(x, ("batch", "seq", None))
            if a is not None:
                aux = aux + a
            entries.append(entry)
        if not emit_cache:
            return x, None, aux
        return x, {k: torch.stack([e[k] for e in entries])
                   for k in entries[0]}, aux

    def forward(self, batch: Dict[str, Any], remat: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits over the full sequence (for vlm, over
        the text positions only).

        Returns (logits (B, S_text, vocab), aux loss summed over the
        layers).  Builds a graph where gradients are on and the
        parameters require them; ``remat`` checkpoints each decoder
        block."""
        memory = (self._encode(batch["enc_embeds"])
                  if self.cfg.n_enc_layers else None)
        x = self._input_seq(batch)
        x, _, aux = self._run_layers(x, memory, cache_window=1,
                                     emit_cache=False, remat=remat)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        if self.cfg.family == "vlm":              # only text positions score
            x = x[:, batch["patch_embeds"].shape[1]:]
        return constrain(x @ self.lm_head, ("batch", None, "model")), aux

    # -- caches -----------------------------------------------------------
    def cache_window(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.family == "ssm":
            return 1                            # O(1) recurrent state
        w = cfg.window if cfg.window > 0 else seq_len
        return min(seq_len, w, cfg.decode_window)

    def cache_specs(self, B: int, seq_len: int, dtype=torch.bfloat16
                    ) -> PyTree:
        """The cache of :meth:`init_cache` as tensors on the meta device:
        its shapes and types (``dtype`` for K/V, ``x_last`` and the
        memory; f32 for the recurrent states; an int32 clock), no
        memory."""
        cfg, n = self.cfg, self.head_dim
        L, d = cfg.n_layers, cfg.d_model
        if cfg.family == "ssm":
            layers = {"state": ((L, B, d // n, n, n), torch.float32),
                      "x_last_t": ((L, B, d), dtype),
                      "x_last_c": ((L, B, d), dtype)}
        else:
            shape = (L, B, self.cache_window(seq_len), cfg.n_kv_heads, n)
            layers = {"k": (shape, dtype), "v": (shape, dtype)}
        if cfg.family == "hybrid":
            layers["ssm"] = ((L, B, d, cfg.ssm_state), torch.float32)
        cache = {"layers": layers, "t": ((), torch.int32)}
        if cfg.n_enc_layers:
            S_enc = max(1, seq_len // cfg.enc_seq_divisor)
            shape = (L, B, S_enc, cfg.n_kv_heads, n)
            cache["memory"] = {"mk": (shape, dtype), "mv": (shape, dtype)}
        return _tree_map(cache, lambda sd: torch.empty(
            sd[0], dtype=sd[1], device="meta"))

    def init_cache(self, B: int, seq_len: int, dtype=torch.float32
                   ) -> PyTree:
        return _tree_map(self.cache_specs(B, seq_len, dtype),
                         lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                               device=self.device))

    # -- prefill / decode ---------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], seq_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """Run the prompt; return (last-position logits (B, vocab),
        cache).  ``seq_len`` sizes the KV cache window (defaults to the
        prompt length, i.e. a full-history cache); for vlm the prompt
        and the clock include the patch prefix."""
        memory = (self._encode(batch["enc_embeds"])
                  if self.cfg.n_enc_layers else None)
        x = self._input_seq(batch)
        S_total = x.shape[1]
        x, layers, _ = self._run_layers(
            x, memory, self.cache_window(seq_len or S_total),
            emit_cache=True)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = x[:, -1] @ self.lm_head
        cache = {"layers": layers,
                 "t": torch.tensor(S_total, dtype=torch.int32,
                                   device=x.device)}
        if memory is not None:
            cache["memory"] = {k: layers.pop(k) for k in ("mk", "mv")}
        return logits, cache

    def _decode_block(self, lp, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor], t,
                      memory: Optional[Dict[str, torch.Tensor]]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        eps = cfg.norm_eps
        if cfg.family == "ssm":
            xt = rmsnorm(x, lp["ln_t"], eps)
            t_out, st, xl_t = rw.time_mix_decode(lp, xt, cache["state"],
                                                 cache["x_last_t"])
            x = x + t_out
            xc = rmsnorm(x, lp["ln_c"], eps)
            c_out, xl_c = rw.channel_mix(lp, xc, cache["x_last_c"])
            x = x + c_out
            return x, {"state": st, "x_last_t": xl_t, "x_last_c": xl_c}
        h_in = rmsnorm(x, lp["norm1"], eps)
        a_out, k_c, v_c = decode_attention(
            lp["attn"], h_in, cache["k"], cache["v"], t,
            theta=cfg.rope_theta, window=cfg.window)
        entry = {"k": k_c, "v": v_c}
        if cfg.family == "hybrid":
            s_out, entry["ssm"] = hy.ssm_step(lp["ssm"], h_in, cache["ssm"])
            x = self._mix_heads(lp, x, a_out, s_out)
        else:
            x = x + a_out
        if cfg.family == "encdec":
            xm = rmsnorm(x, lp["norm_x"], eps)
            x = x + cross_attention(lp["xattn"], xm, memory["mk"],
                                    memory["mv"])
        x, _ = self._ffn(lp, x)
        return x, entry

    @torch.no_grad()
    def decode_step(self, cache: PyTree, token) -> Tuple[torch.Tensor,
                                                          PyTree]:
        """One decode step.  token: (B,) int.  Returns (logits (B,
        vocab), a new cache; the given one is not changed).  The encdec
        memory is read, never written, and not copied: the returned cache
        shares the given one's ``memory`` tensors, so an in-place write to
        either (as ``ServeEngine._splice`` makes) reaches both."""
        x = embed(self.embed, torch.as_tensor(token)[:, None])
        x = constrain(x, ("batch", "seq", None))
        layers = cache["layers"]
        memory = cache.get("memory")
        entries = []
        for i, lp in enumerate(self.layers):
            x, entry = self._decode_block(
                lp, x, {k: c[i] for k, c in layers.items()}, cache["t"],
                None if memory is None
                else {k: m[i] for k, m in memory.items()})
            entries.append(entry)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = x[:, -1] @ self.lm_head
        new_cache = dict(cache)
        new_cache["layers"] = {k: torch.stack([e[k] for e in entries])
                               for k in entries[0]}
        new_cache["t"] = cache["t"] + 1
        return logits, new_cache
