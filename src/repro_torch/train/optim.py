"""AdamW with global-norm clipping: the counterpart of the reference
package's ``train/optim.py``.

The optimizer state mirrors the parameters, a dict of tensors by name:
``m`` and ``v`` per leaf (f32 from :func:`adamw_init`; a moment kept in
another type, bf16, is stored back in it) and an int32 ``step``.

This is not ``torch.optim.AdamW``, which computes the same update in
another order (``p·(1 - lr·wd)`` first, then ``sqrt(v)/sqrt(1 - b2^t) +
eps``) and so rounds otherwise, and which has no global-norm clip.
:func:`adamw_update` does the reference's arithmetic in its order: the
clip scale from the global norm, bias corrections by ``step``, ``delta =
mh / (sqrt(vh) + eps) + wd·p``, ``p - lr·delta``.
It updates in place, one leaf at a time and under ``no_grad``, so that a
large model needs no second copy of its weights or moments.
:func:`opt_specs` is the state's shape-only twin, on the meta device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Tensors) -> Dict[str, object]:
    """Zero f32 moments laid out as each parameter (on its device, or
    placed as its DTensor), and step 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_specs(param_specs, moment_dtype=torch.float32):
    """The tree of :func:`adamw_init` as tensors on the meta device (the
    dry-run's stand-in): ``m`` and ``v`` mirror ``param_specs`` (nested
    dicts of tensors) in ``moment_dtype``, plus an int32 ``step``."""
    def moments(tree):
        return {k: moments(t) if isinstance(t, dict) else
                torch.empty(t.shape, dtype=moment_dtype, device="meta")
                for k, t in tree.items()}
    return {"m": moments(param_specs), "v": moments(param_specs),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _global_norm(grads: Tensors) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Tensors, opt_state,
                 params: Tensors) -> Tuple[Tensors, dict, torch.Tensor]:
    """One AdamW step with global-norm clipping, in place.

    Returns (params, opt_state, grad_norm): the given ``params`` dict and
    moment dicts, their tensors updated, and a new ``step``.  The grad
    norm is the raw one, before clipping."""
    step = opt_state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1t = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2t = 1.0 - cfg.b2 ** step.to(torch.float32)
    for k, p in params.items():
        m_s, v_s = opt_state["m"][k], opt_state["v"][k]
        g = grads[k].to(torch.float32) * scale
        m = cfg.b1 * m_s.to(torch.float32) + (1 - cfg.b1) * g
        v = cfg.b2 * v_s.to(torch.float32) + (1 - cfg.b2) * g * g
        delta = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps) \
            + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - cfg.lr * delta)
        m_s.copy_(m)
        v_s.copy_(v)
        del g, m, v, delta          # this leaf's temporaries, before the next
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, gnorm
