"""Architecture configuration schema shared by the model zoo (a copy of
the reference package's ``configs/base.py``: pure dataclasses).

Every assigned architecture gets one ``repro_torch/configs/<id>.py``
module exporting ``FULL`` (the exact published config, cited) and
``SMOKE`` (a reduced same-family variant for CPU tests: <=2 layers,
d_model<=512, <=4 experts).  :mod:`repro_torch.configs.registry`
resolves ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int                # 0 for attention-free families
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # --- MoE -----------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- attention windows ----------------------------------------------
    window: int = 0             # 0 = full causal; >0 = sliding window (train)
    decode_window: int = 32768  # KV-cache window for long-context decode
    # --- SSM -------------------------------------------------------------
    ssm_state: int = 0          # Mamba/RWKV state size N
    # --- encoder-decoder --------------------------------------------------
    n_enc_layers: int = 0       # 0 = decoder-only
    enc_seq_divisor: int = 4    # encoder frames = seq_len // divisor
    # --- modality frontend stub ------------------------------------------
    n_prefix: int = 0           # patch/frame embedding prefix tokens (VLM)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    citation: str = ""

    def __post_init__(self) -> None:
        if self.n_heads and self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)
        if self.n_heads:
            if self.n_heads % max(1, self.n_kv_heads):
                raise ValueError("n_heads must be divisible by n_kv_heads")
            if self.head_dim * self.n_heads != self.d_model \
                    and self.family != "hybrid":
                # hybrid (hymba) uses head_dim*n_heads == d_model too; keep
                # the check strict everywhere.
                raise ValueError(
                    f"{self.name}: head_dim*n_heads != d_model")
        if self.family == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError("moe family needs n_experts and top_k")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError("ssm/hybrid family needs ssm_state")

    # ------------------------------------------------------------------
    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def q_groups(self) -> int:
        """Query heads per KV head (GQA group size)."""
        return self.n_heads // max(1, self.n_kv_heads)

    def n_params(self) -> int:
        """Parameter count (embedding + blocks + head), for 6·N·D."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        total = v * d * 2                       # embed + lm head
        total += d                              # final norm
        per_layer = self._block_params()
        total += self.n_layers * per_layer
        if self.n_enc_layers:
            total += self.n_enc_layers * self._enc_block_params()
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE routes top_k of n_experts)."""
        if self.family != "moe":
            return self.n_params()
        d, f = self.d_model, self.d_ff
        dense = self.n_params() - self.n_layers * self._ffn_params()
        active_ffn = self.n_layers * (
            3 * d * f * self.top_k + d * self.n_experts)  # + router
        return dense + active_ffn

    # -- helpers -----------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        return (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)

    def _ffn_params(self) -> int:
        d, f = self.d_model, self.d_ff
        if self.family == "moe":
            return self.n_experts * 3 * d * f + d * self.n_experts
        return 3 * d * f

    def _block_params(self) -> int:
        d = self.d_model
        if self.family == "ssm":
            # rwkv6: time-mix (r,k,v,w,g ~ 5 d², output d²) + channel-mix.
            return 6 * d * d + 3 * d * self.d_ff // 1 + 2 * d
        if self.family == "hybrid":
            ssm = 2 * d * d + 2 * d * self.ssm_state * 2 + d
            return self._attn_params() + ssm + self._ffn_params() + 2 * d
        base = self._attn_params() + self._ffn_params() + 2 * d
        if self.family == "encdec":
            base += self._attn_params() + d      # cross-attention + norm
        return base

    def _enc_block_params(self) -> int:
        return self._attn_params() + 3 * self.d_model * self.d_ff \
            + 2 * self.d_model


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
