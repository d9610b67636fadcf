"""Activation-sharding hints for the model code: the counterpart of the
reference package's ``sharding/context.py``.

The model code carries the reference's hints without being coupled to
a mesh:

* launchers install an :class:`ActivationSharding` with
  ``use_activation_sharding(mesh)`` around the model's calls;
* model code calls :func:`constrain` with a *logical* spec such as
  ``("batch", None, "model", None)``;
* with no context installed ``constrain`` returns its input itself, so
  the unsharded port computes exactly what it computed without hints;
* axes that do not divide the corresponding dim fall back to ``None``
  (e.g. 25 hymba heads on a 16-way ``model`` axis).

Under a context, a ``DTensor`` is redistributed to the resolved
placements: ``Shard(d)`` on each mesh dimension named for tensor dim
``d``, ``Replicate()`` on the others (and on each mesh dimension of
size 1: ``dtensor_placements``).  A plain tensor is returned
unchanged: eager torch has no sharding propagation to pin, and a plain
tensor is one rank's local data, so making it a DTensor would claim
what the other ranks hold, which ``constrain`` cannot know.  The model's
activations become DTensors where they meet DTensor parameters
(:func:`repro_torch.sharding.auto.distribute_state_dict`).

The context also turns on DTensor's implicit replication: the model
makes plain tensors (zeros, positions, masks) that meet DTensor
activations, and they are taken as replicated on the mesh.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..launch.combo_cache import mesh_key
from .auto import dtensor_placements, to_placements

_STATE = threading.local()

Logical = Union[None, str, Tuple[str, ...]]


class ActivationSharding:
    def __init__(self, mesh, seq_shard: bool = False) -> None:
        self.mesh = mesh
        self.sizes = dict(mesh_key(mesh))
        batch = tuple(a for a in ("pod", "data") if a in self.sizes)
        # "seq" is the Megatron-style sequence-parallel hint: layer-boundary
        # activations shard S over ``model`` when enabled, else the hint
        # resolves to replicated.
        self.logical = {"batch": batch, "model": ("model",),
                        "seq": ("model",) if seq_shard else ()}

    def resolve(self, dim: int, logical: Logical) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        axes = self.logical.get(logical, (logical,)) \
            if isinstance(logical, str) else logical
        if not axes:
            return None
        # Longest prefix of the axis tuple that divides the dim.
        for k in range(len(axes), 0, -1):
            prod = math.prod(self.sizes[a] for a in axes[:k])
            if dim % prod == 0 and dim >= prod:
                return tuple(axes[:k])
        return None


@contextlib.contextmanager
def use_activation_sharding(mesh, seq_shard: bool = False):
    """Install a context over ``mesh`` (``None`` installs none) for the
    ``with`` body, and DTensor's implicit replication with it."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = (ActivationSharding(mesh, seq_shard=seq_shard)
                  if mesh is not None else None)
    try:
        with (implicit_replication() if mesh is not None
              else contextlib.nullcontext()):
            yield
    finally:
        _STATE.ctx = prev


def current() -> Optional[ActivationSharding]:
    return getattr(_STATE, "ctx", None)


def axis_size(name: str) -> int:
    """Mesh size of a logical axis under the installed context (1 if no
    context) — lets model code pick between equivalent layouts, e.g.
    head-sharded vs q-sequence-sharded attention chunks."""
    ctx = current()
    if ctx is None:
        return 1
    axes = ctx.logical.get(name, (name,))
    size = 1
    for a in axes:
        size *= ctx.sizes.get(a, 1)
    return size


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` replicated on every rank: a DTensor redistributed to
    ``Replicate()`` on each mesh dimension (no copy where it already is);
    a plain tensor itself.  In-place writes into a slice of a DTensor
    (the engine's cache splices) need it: DTensor has no in-place rule
    for a slice of a sharded dim."""
    if not isinstance(x, DTensor):
        return x
    full = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == full else x.redistribute(
        x.device_mesh, full)


def gathered(x: torch.Tensor) -> torch.Tensor:
    """The whole of ``x`` as a plain tensor (a DTensor's
    ``full_tensor()``), for reading on the host."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def constrain(x: torch.Tensor, spec: Sequence[Logical]) -> torch.Tensor:
    """Pin ``x`` to a logical sharding if a context is installed."""
    ctx = current()
    if ctx is None:
        return x
    if len(spec) != x.ndim:
        raise ValueError(f"spec rank {len(spec)} != array rank {x.ndim}")
    if not isinstance(x, DTensor):
        return x
    placements = dtensor_placements(to_placements(
        [ctx.resolve(int(d), s) for d, s in zip(x.shape, spec)], ctx.mesh),
        ctx.mesh)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(ctx.mesh, placements)
