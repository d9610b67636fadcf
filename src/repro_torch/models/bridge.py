"""Carry the reference's weights across into the port's :class:`Model`,
and its AdamW state into the port's train step.

``jax.random`` draws cannot be reproduced in torch, so every parity test
starts both packages from the same numbers: the reference's parameter
tree as numpy arrays (``jax.tree.map(np.asarray, params)``, or what
``load_checkpoint`` of either package returns), with per-layer leaves
stacked along a leading axis (``layers``: ``n_layers`` rows; ``encoder``:
``n_enc_layers`` rows), becomes the port's state dict with that axis
unstacked into the module list.  Layer leaves may sit at any depth
(``layers.attn.wq`` of a dense block); their key path joins with dots,
as the port's nested ``ParameterDict`` names them.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..device import resolve_device


def params_from_reference(cfg: ArchConfig, tree: Dict[str, Any], *,
                          device=None, dtype=None
                          ) -> Dict[str, torch.Tensor]:
    """The port's state dict (``embed``, ``layers.<l>.<key path>``,
    ``encoder.<l>.<key path>``, ``enc_norm``, ``final_norm``,
    ``lm_head``) for ``model.load_state_dict(sd, assign=True)``.
    ``dtype=None`` keeps the arrays' own type; ``device=None`` is CUDA.
    Raises ``ValueError`` when a stacked leaf does not have one row per
    layer of its stack."""
    dev = resolve_device(device)
    stacks = {"layers": (cfg.n_layers, "layers"),
              "encoder": (cfg.n_enc_layers, "encoder layers")}

    def tensor(a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a))          # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    def unstack(stack: str, name: str, stacked) -> None:
        if isinstance(stacked, dict):
            for k, sub in stacked.items():
                unstack(stack, f"{name}.{k}", sub)
            return
        n, what = stacks[stack]
        if np.shape(stacked)[0] != n:
            raise ValueError(
                f"{stack}/{name.replace('.', '/')} has "
                f"{np.shape(stacked)[0]} rows, {cfg.name} has {n} {what}")
        for i in range(n):
            sd[f"{stack}.{i}.{name}"] = tensor(stacked[i])

    sd: Dict[str, torch.Tensor] = {}
    for key, leaf in tree.items():
        if key not in stacks:
            sd[key] = tensor(leaf)
            continue
        for name, stacked in leaf.items():
            unstack(key, name, stacked)
    return sd


def opt_state_from_reference(cfg: ArchConfig, opt_tree: Dict[str, Any], *,
                             device=None) -> Dict[str, Any]:
    """The port's AdamW state (:func:`repro_torch.train.adamw_init`'s
    layout: ``m`` and ``v`` by parameter name, an int32 ``step``) from
    the reference's ``{"m": tree, "v": tree, "step": scalar}``, whose
    moments are shaped as the parameter tree: each moment is unstacked as
    :func:`params_from_reference` unstacks the parameters, in f32.
    ``device=None`` is CUDA.  Raises ``ValueError`` when a stacked
    moment does not have one row per layer of its stack."""
    dev = resolve_device(device)
    return {"m": params_from_reference(cfg, opt_tree["m"], device=dev,
                                       dtype=torch.float32),
            "v": params_from_reference(cfg, opt_tree["v"], device=dev,
                                       dtype=torch.float32),
            "step": torch.tensor(int(np.asarray(opt_tree["step"])),
                                 dtype=torch.int32, device=dev)}
