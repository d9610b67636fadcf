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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
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


def _unshard(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` sharded over no mesh dimension:
    each ``Shard(d)`` with ``d`` in ``dims`` becomes ``Replicate()`` (an
    all-gather); other placements stay.  For an op whose DTensor rule
    refuses a sharded dim, such as a view that splits a dim the mesh
    does not divide along the split.  A plain tensor, or a DTensor with
    none of ``dims`` sharded (every one at world size 1), is returned
    itself."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    new = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                for p in x.placements)
    return x if new == tuple(x.placements) else x.redistribute(
        x.device_mesh, new)


def shard_ways(x: torch.Tensor, dim: int) -> int:
    """How many ways tensor dim ``dim`` of ``x`` is sharded: the product
    of the sizes of the mesh dims that shard it (1 for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return 1
    d = dim % x.ndim
    return math.prod(x.device_mesh.size(i)
                     for i, p in enumerate(x.placements)
                     if isinstance(p, Shard) and p.dim == d)


def _split_ready(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    return x if outer % shard_ways(x, dim) == 0 else _unshard(x, (dim,))


class _Splittable(torch.autograd.Function):
    """Identity whose gradient is made ready for the same split."""

    @staticmethod
    def forward(ctx, x, dim, outer):
        ctx.dim, ctx.outer = dim, outer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _split_ready(grad, ctx.dim, ctx.outer), None, None


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x`` ready for a view that splits dim ``dim`` into ``(outer,
    ...)``, or (the backward of a flatten) whose gradient a view splits
    so: the dim is unsharded (:func:`_unshard`), in the forward pass and
    in the gradient, where the mesh dims that shard it do not divide
    ``outer``, which DTensor's view rule refuses.  A plain tensor is
    returned itself."""
    if not isinstance(x, DTensor):
        return x
    return _Splittable.apply(_split_ready(x, dim, outer), dim, outer)


def flattenable(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x`` ready for a view that flattens dims ``start`` to ``end``
    (inclusive) into one: torch 2.11's DTensor takes only a group whose
    first dim alone is sharded, and evenly; every other shard in the
    group is unsharded (:func:`_unshard`).  A plain tensor is returned
    itself."""
    if not isinstance(x, DTensor):
        return x
    start, end = start % x.ndim, end % x.ndim
    drop = [d for d in range(start, end + 1) if shard_ways(x, d) > 1
            and (d != start or x.shape[d] % shard_ways(x, d))]
    return _unshard(x, drop) if drop else x


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a gradient a DTensor
    hands back to local tensors may be broadcast (stride 0), which the
    views in an einsum's backward cannot take."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, with its gradient made contiguous (:class:`_ContiguousGrad`);
    for a rank's local tensor that a DTensor wraps."""
    return _ContiguousGrad.apply(x)


def local_range(mesh, placements, dim: int, size: int) -> slice:
    """This rank's slice of a tensor dim of ``size`` sharded as
    ``placements`` (``torch.chunk`` pieces, split in mesh order)."""
    start, length = 0, size
    coord = mesh.get_coordinate()
    for i, q in enumerate(placements):
        if isinstance(q, Shard) and q.dim == dim:
            chunk = -(-length // mesh.size(i))
            lo = min(coord[i] * chunk, length)
            start, length = start + lo, min(chunk, length - lo)
    return slice(start, start + length)


def local_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)``; on DTensors, computed from each rank's
    local shards where the placements let it, without DTensor's einsum
    (which flattens the batch letters, a view torch 2.11 refuses when an
    inner one of them is sharded).

    On each mesh dim one letter is sharded: every operand with that
    letter is sharded on it (a replicated one is chunked there, which
    moves nothing), every operand without it is replicated, and the
    result is sharded on the letter, or a partial sum where the letter
    is contracted.  Where operands shard two letters on one mesh dim,
    the first of them in the output stays and the others are gathered;
    one partial operand among replicated ones gives a partial result,
    and a partial sum beside a shard is reduced first.  At world size 1
    every placement is ``Replicate()``, so the local einsum is the plain
    one."""
    if not any(isinstance(o, DTensor) for o in ops):
        return torch.einsum(eq, *ops)
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(o for o in ops if isinstance(o, DTensor)).device_mesh
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    if any(o.device_mesh != mesh for o in ops):
        return torch.einsum(eq, *ops)
    ops = [_reduce_partials(o, ops) for o in ops]
    want = [list(o.placements) for o in ops]
    out_pl = []
    for m in range(mesh.ndim):
        letters = set()
        partial = None
        for o, spec in zip(ops, ins):
            p = o.placements[m]
            if type(p) is Shard:
                letters.add(spec[p.dim])
            elif isinstance(p, Partial):
                partial = p
            elif not isinstance(p, Replicate):
                return torch.einsum(eq, *ops)
        if partial is not None:           # one partial sum, the rest whole
            out_pl.append(partial)
            continue
        if not letters:
            out_pl.append(Replicate())
            continue
        # Two letters on one mesh dim: the first of them in the output
        # stays sharded there, the others are gathered.
        letter = min(letters, key=lambda c: (c not in out, out.find(c), c))
        for w, spec in zip(want, ins):
            w[m] = (Shard(spec.index(letter)) if letter in spec
                    else Replicate())
        out_pl.append(Shard(out.index(letter)) if letter in out
                      else Partial())
    ops = [o if list(o.placements) == w else o.redistribute(mesh, w)
           for o, w in zip(ops, want)]
    sizes = {c: n for o, spec in zip(ops, ins) for c, n in zip(spec, o.shape)}
    local = torch.einsum(eq, *(contiguous_grad(o.to_local()) for o in ops))
    shape = tuple(sizes[c] for c in out)
    return DTensor.from_local(local, mesh, out_pl, run_check=False,
                              shape=shape, stride=_strides_like(local, shape))


def _reduce_partials(o: DTensor, ops) -> DTensor:
    """``o`` with each partial sum reduced (``Replicate()``) on a mesh dim
    where another operand is partial or sharded too: an einsum is linear
    in each operand, so one partial operand among whole ones may stay."""
    pl = list(o.placements)
    for m, p in enumerate(pl):
        if isinstance(p, Partial) and any(
                q is not o and not isinstance(q.placements[m], Replicate)
                for q in ops):
            pl[m] = Replicate()
    return o if pl == list(o.placements) else o.redistribute(
        o.device_mesh, pl)


def _strides_like(local: torch.Tensor, shape) -> Tuple[int, ...]:
    """Dense strides for ``shape`` in the dim order of ``local``'s layout
    (an einsum may return a permuted view)."""
    order = sorted(range(local.ndim), key=lambda i: (-local.stride(i), i))
    stride, acc = [0] * local.ndim, 1
    for i in reversed(order):
        stride[i] = acc
        acc *= shape[i]
    return tuple(stride)


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
