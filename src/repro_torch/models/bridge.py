"""Carry the reference's weights across into the port's :class:`Model`.

``jax.random`` draws cannot be reproduced in torch, so every parity test
starts both packages from the same numbers: the reference's parameter
tree as numpy arrays (``jax.tree.map(np.asarray, params)``, or what
``load_checkpoint`` of either package returns), with per-layer leaves
stacked along a leading ``L`` axis, becomes the port's state dict with
that axis unstacked into the module list.  Layer leaves may sit at any
depth (``layers.attn.wq`` of a dense block); their key path joins with
dots, as the port's nested ``ParameterDict`` names them.
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
    ``final_norm``, ``lm_head``) for ``model.load_state_dict(sd,
    assign=True)``.  ``dtype=None`` keeps the arrays' own type;
    ``device=None`` is CUDA.  Raises ``ValueError`` when a layer leaf
    does not have ``cfg.n_layers`` rows."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        t = torch.from_numpy(np.array(a))          # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    def unstack(name: str, stacked) -> None:
        if isinstance(stacked, dict):
            for k, sub in stacked.items():
                unstack(f"{name}.{k}", sub)
            return
        if np.shape(stacked)[0] != cfg.n_layers:
            raise ValueError(
                f"layers/{name.replace('.', '/')} has "
                f"{np.shape(stacked)[0]} rows, {cfg.name} has "
                f"{cfg.n_layers} layers")
        for i in range(cfg.n_layers):
            sd[f"layers.{i}.{name}"] = tensor(stacked[i])

    sd: Dict[str, torch.Tensor] = {}
    for key, leaf in tree.items():
        if key != "layers":
            sd[key] = tensor(leaf)
            continue
        for name, stacked in leaf.items():
            unstack(name, stacked)
    return sd
