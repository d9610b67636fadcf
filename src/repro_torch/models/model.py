"""The model zoo: ``ArchConfig`` -> init / forward / prefill / decode.

The counterpart of the reference package's ``models/model.py`` for the
families ported so far: the ``ssm`` family (RWKV-6).  The others raise
``NotImplementedError`` until their slice lands (ROADMAP queue 1,
item 5).

Where the reference stacks per-layer parameters along a leading ``L``
axis and scans over them with ``lax.scan``, the port keeps one
``nn.ParameterDict`` per layer in an ``nn.ModuleList`` and loops in
Python.  Parameter names are the reference's keys (``embed``,
``layers.<l>.<key>``, ``final_norm``, ``lm_head``), so
:func:`repro_torch.models.bridge.params_from_reference` carries its
weights across.  The cache keeps the reference's layout and keys:
``layers.state (L,B,H,n,n) f32``, ``layers.x_last_t`` and ``x_last_c``
``(L,B,d)``, and ``t``.

A ``Model`` is built on the meta device, so it holds no memory until
:meth:`Model.init` draws its weights or ``load_state_dict(...,
assign=True)`` takes them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import rwkv6 as rw
from .layers import dense_init, embed, init_embed, rmsnorm

PyTree = Any
WKV_BACKENDS = rw.TIME_MIX_BACKENDS


def _residual_out_scale(n_layers: int) -> float:
    """GPT-2/Megatron depth scaling for residual-output projections."""
    return 1.0 / math.sqrt(max(1, 2 * n_layers))


def _meta(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device="meta"),
                        requires_grad=False)


class Model(nn.Module):
    """One model of the zoo on one device.

    ``device=None`` is CUDA (raises without it); pass ``"cpu"`` to run
    on the host.  ``wkv_backend`` ("kernel" or "scan") is the
    ``time_mix`` backend of every layer on the full-sequence path.
    """

    def __init__(self, cfg: ArchConfig, *, device=None,
                 wkv_backend: str = "kernel") -> None:
        super().__init__()
        if cfg.family != "ssm":
            raise NotImplementedError(
                f"the {cfg.family} family is not ported yet (ROADMAP "
                f"queue 1, item 5)")
        if wkv_backend not in WKV_BACKENDS:
            raise ValueError(f"unknown wkv_backend {wkv_backend!r}; "
                             f"expected {WKV_BACKENDS}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.wkv_backend = wkv_backend
        self.head_dim = cfg.head_dim or 64
        d, V = cfg.d_model, cfg.vocab
        shapes = rw.spec_rwkv_block(d, cfg.d_ff, self.head_dim)
        self.embed = _meta(V, d)
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: _meta(*s) for k, s in shapes.items()})
            for _ in range(cfg.n_layers))
        self.final_norm = _meta(d)
        self.lm_head = _meta(d, V)

    # -- parameters -----------------------------------------------------
    def init(self, generator: torch.Generator, dtype=torch.float32
             ) -> "Model":
        """Draw every weight from ``generator`` (in the reference's
        distributions, not its numbers) in ``dtype``; returns self."""
        cfg = self.cfg

        def put(t: torch.Tensor) -> nn.Parameter:
            return nn.Parameter(t.to(self.device), requires_grad=False)

        rs = _residual_out_scale(cfg.n_layers)
        self.embed = put(init_embed(generator, cfg.vocab, cfg.d_model,
                                    dtype))
        for lp in self.layers:
            block = rw.init_rwkv_block(generator, cfg.d_model, cfg.d_ff,
                                       self.head_dim, dtype, out_scale=rs)
            for k, t in block.items():
                lp[k] = put(t)
        self.final_norm = put(torch.ones(cfg.d_model, dtype=dtype))
        self.lm_head = put(dense_init(generator, (cfg.d_model, cfg.vocab),
                                      dtype, scale=0.02))
        return self

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- full-sequence pass -------------------------------------------------
    def _seq_block(self, lp, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One block over the full sequence; returns (x, cache entry)."""
        cfg = self.cfg
        st0 = torch.zeros(rw.rwkv_state_shape(x.shape[0], cfg.d_model,
                                              self.head_dim),
                          dtype=torch.float32, device=x.device)
        xt = rmsnorm(x, lp["ln_t"], cfg.norm_eps)
        t_out, st, xl_t = rw.time_mix(lp, xt, st0, torch.zeros_like(xt[:, 0]),
                                      backend=self.wkv_backend)
        x = x + t_out
        xc = rmsnorm(x, lp["ln_c"], cfg.norm_eps)
        c_out, xl_c = rw.channel_mix(lp, xc, torch.zeros_like(xc[:, 0]))
        x = x + c_out
        return x, {"state": st, "x_last_t": xl_t, "x_last_c": xl_c}

    def _run_layers(self, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        entries = []
        for lp in self.layers:
            x, entry = self._seq_block(lp, x)
            entries.append(entry)
        return x, {k: torch.stack([e[k] for e in entries])
                   for k in entries[0]}

    def forward(self, batch: Dict[str, Any]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits over the full sequence.

        Returns (logits (B, S, vocab), aux loss scalar)."""
        x = embed(self.embed, batch["tokens"])
        for lp in self.layers:
            x, _ = self._seq_block(lp, x)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        return x @ self.lm_head, torch.zeros((), device=x.device)

    # -- caches -----------------------------------------------------------
    def cache_window(self, seq_len: int) -> int:
        return 1                                # O(1) recurrent state

    def init_cache(self, B: int, seq_len: int, dtype=torch.float32
                   ) -> PyTree:
        cfg, n = self.cfg, self.head_dim
        L, d, H = cfg.n_layers, cfg.d_model, cfg.d_model // n
        z = dict(device=self.device)
        return {"layers": {
                    "state": torch.zeros((L, B, H, n, n),
                                         dtype=torch.float32, **z),
                    "x_last_t": torch.zeros((L, B, d), dtype=dtype, **z),
                    "x_last_c": torch.zeros((L, B, d), dtype=dtype, **z)},
                "t": torch.zeros((), dtype=torch.int32, **z)}

    # -- prefill / decode ---------------------------------------------------
    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], seq_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, PyTree]:
        """Run the prompt; return (last-position logits (B, vocab),
        cache).  ``seq_len`` sizes an attention cache window; the
        recurrent state of this family needs none."""
        x = embed(self.embed, batch["tokens"])
        S_total = x.shape[1]
        x, caches = self._run_layers(x)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = x[:, -1] @ self.lm_head
        return logits, {"layers": caches,
                        "t": torch.tensor(S_total, dtype=torch.int32,
                                          device=x.device)}

    def _decode_block(self, lp, x: torch.Tensor,
                      cache: Dict[str, torch.Tensor]
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        eps = self.cfg.norm_eps
        xt = rmsnorm(x, lp["ln_t"], eps)
        t_out, st, xl_t = rw.time_mix_decode(lp, xt, cache["state"],
                                             cache["x_last_t"])
        x = x + t_out
        xc = rmsnorm(x, lp["ln_c"], eps)
        c_out, xl_c = rw.channel_mix(lp, xc, cache["x_last_c"])
        x = x + c_out
        return x, {"state": st, "x_last_t": xl_t, "x_last_c": xl_c}

    @torch.no_grad()
    def decode_step(self, cache: PyTree, token) -> Tuple[torch.Tensor,
                                                          PyTree]:
        """One decode step.  token: (B,) int.  Returns (logits (B,
        vocab), a new cache; the given one is not changed)."""
        x = embed(self.embed, torch.as_tensor(token)[:, None])
        layers = cache["layers"]
        entries = []
        for i, lp in enumerate(self.layers):
            x, entry = self._decode_block(
                lp, x, {k: c[i] for k, c in layers.items()})
            entries.append(entry)
        x = rmsnorm(x, self.final_norm, self.cfg.norm_eps)
        logits = x[:, -1] @ self.lm_head
        new_cache = dict(cache)
        new_cache["layers"] = {k: torch.stack([e[k] for e in entries])
                               for k in entries[0]}
        new_cache["t"] = cache["t"] + 1
        return logits, new_cache
