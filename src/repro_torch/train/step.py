"""Train-step factory: loss + gradients + AdamW update; the counterpart
of the reference package's ``train/step.py``.

The reference's ``make_train_step(cfg)`` returns a pure function
``(params, opt_state, batch) -> (params, opt_state, metrics)`` for
``jax.jit``.  Here a :class:`~repro_torch.models.model.Model` holds its
weights, so the factory takes the model, as the serving step factories
do, and returns ``(opt_state, batch) -> (opt_state, metrics)``, which
updates the model's parameters in place.

The model must run RWKV-6 through ``wkv_backend="scan"``, the route the
reference's train step differentiates: the CUDA WKV kernel has no
backward (``kernels.ops.wkv6`` raises under autograd).  Activation
checkpointing (``remat``) of each decoder block is the default, as in
the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ArchConfig
from ..models.model import Model
from .loss import cross_entropy_loss
from .optim import AdamWConfig, adamw_init, adamw_update

Batch = Dict[str, torch.Tensor]
AUX_WEIGHT = 0.01     # MoE load-balance loss weight


def loss_and_grads(model: Model, batch: Batch, *, remat: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              Dict[str, torch.Tensor]]:
    """(total, loss, aux, gradients by parameter name) of ``loss +
    AUX_WEIGHT·aux`` on ``batch``; turns ``requires_grad`` on for every
    parameter of ``model``.  A parameter the loss does not reach gets a
    zero gradient, as ``jax.grad`` gives it."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    with torch.enable_grad():
        logits, aux = model(batch, remat=remat)
        loss = cross_entropy_loss(logits, batch["labels"])
        total = loss + AUX_WEIGHT * aux
        gs = torch.autograd.grad(total, list(params.values()),
                                 allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), gs)}
    return total.detach(), loss.detach(), aux.detach(), grads


def _split(batch: Batch, microbatches: int):
    """``microbatches`` consecutive slices of every leaf's batch axis."""
    for x in batch.values():
        b = x.shape[0]
        if b % microbatches:
            raise ValueError(
                f"batch {b} not divisible by {microbatches} ubatches")
    n = next(iter(batch.values())).shape[0] // microbatches
    return [{k: x[i * n:(i + 1) * n] for k, x in batch.items()}
            for i in range(microbatches)]


def make_train_step(model: Model, opt_cfg: AdamWConfig = AdamWConfig(), *,
                    remat: bool = True, microbatches: int = 1
                    ) -> Callable[[Any, Batch], Tuple[Any, Dict[str, Any]]]:
    """``(opt_state, batch) -> (opt_state, metrics)``: one AdamW step of
    ``model``'s parameters on ``batch``, in place.  Metrics (device
    scalars): ``loss``, ``aux_loss``, ``total_loss`` and ``grad_norm``
    (before clipping).

    ``microbatches > 1`` splits the batch and accumulates f32 gradients
    over the slices, then averages them and the three losses; a batch it
    does not divide raises ``ValueError``."""
    if model.cfg.family == "ssm" and model.wkv_backend != "scan":
        raise ValueError(
            f"train through wkv_backend='scan': the {model.wkv_backend!r} "
            f"route has no backward")
    params = dict(model.named_parameters())

    def train_step(opt_state, batch: Batch):
        if microbatches == 1:
            total, loss, aux, grads = loss_and_grads(model, batch,
                                                     remat=remat)
        else:
            grads = {k: torch.zeros_like(p, dtype=torch.float32)
                     for k, p in params.items()}
            sums = torch.zeros(3, dtype=torch.float32, device=model.device)
            for ub in _split(batch, microbatches):
                t, l, a, g = loss_and_grads(model, ub, remat=remat)
                for k, acc in grads.items():
                    acc.add_(g[k])
                del g
                sums = sums + torch.stack([t, l, a])
            inv = 1.0 / microbatches
            for acc in grads.values():
                acc.mul_(inv)
            total, loss, aux = sums[0] * inv, sums[1] * inv, sums[2] * inv
        _, opt_state, gnorm = adamw_update(opt_cfg, grads, opt_state, params)
        return opt_state, {"loss": loss, "aux_loss": aux,
                           "total_loss": total, "grad_norm": gnorm}

    return train_step


class TrainState:
    """Thin mutable wrapper used by the training loop: a model drawn
    from ``generator`` (RWKV-6 through ``"scan"``), f32 AdamW moments and
    the step.  ``device=None`` is CUDA (raises without it)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator,
                 opt_cfg: AdamWConfig = AdamWConfig(),
                 dtype=torch.float32, remat: bool = False,
                 device=None) -> None:
        self.cfg = cfg
        self.model = Model(cfg, device=device, wkv_backend="scan").init(
            generator, dtype)
        self.opt_state = adamw_init(dict(self.model.named_parameters()))
        self.step_fn = make_train_step(self.model, opt_cfg, remat=remat)
        self.history = []

    def step(self, batch: Batch) -> Dict[str, float]:
        self.opt_state, metrics = self.step_fn(self.opt_state, batch)
        out = {k: float(v) for k, v in metrics.items()}
        self.history.append(out)
        return out
