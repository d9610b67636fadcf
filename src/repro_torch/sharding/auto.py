"""Deterministic rule-based auto-sharder: the counterpart of the reference
package's ``sharding/auto.py``.

Maps every parameter / input / cache leaf to a :class:`PartitionSpec`
over the production mesh (``data``, ``model``[, ``pod``]), and each spec
to the DTensor placements that realise it on a ``DeviceMesh``:

* **FSDP** — a weight dim is sharded over ``data`` (gathered on use);
* **TP**   — heads / d_ff / vocab dims are sharded over ``model``;
* **EP**   — MoE expert dims go on ``model`` when divisible;
* **batch** — activations shard batch over (``pod``, ``data``).

Rules are matched by path regex and tried in priority order; any dim that
fails the divisibility check falls back down the candidate list and
ultimately to replication.  ``PARAM_RULES`` is the reference's table,
regexes, dims and order unchanged.

Paths are the reference's: ``/``-joined keys of a stacked tree
(``layers/attn/wq``).  The port's state-dict keys are unstacked
(``layers.3.attn.wq``); :func:`reference_path` drops the layer index and
joins with ``/``, and since the rules' dims count from the end, an
unstacked leaf gets the stacked leaf's spec without its leading ``None``.

The rule functions read only a mesh's axis names and sizes (through
:func:`~repro_torch.launch.combo_cache.mesh_key`), so a
:class:`MeshShape` stands in for a 16×16 mesh that no test can build, as
``AbstractMesh`` does in the reference.  ``param_shardings``,
``batch_specs`` and ``cache_specs_sharding`` return, per leaf, the
placements of :func:`to_placements`: one ``Shard(dim)`` or
``Replicate()`` per mesh dimension, in mesh order.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from torch import nn
from torch.distributed.tensor import (Placement, Replicate, Shard,
                                      distribute_tensor)

from ..launch.combo_cache import mesh_key

PyTree = Any

# (path regex, [(dim, axis), ...]) — dims are negative (counted from the
# end) so the same rule covers stacked (leading-L) and unstacked leaves.
PARAM_RULES: List[Tuple[str, List[Tuple[int, str]]]] = [
    # embeddings / head
    (r"(^|/)embed$",            [(-2, "model"), (-1, "data")]),
    (r"(^|/)lm_head$",          [(-1, "model"), (-2, "data")]),
    # attention (decoder, cross, encoder)
    (r"(attn|xattn)/wq$",       [(-2, "model"), (-3, "data")]),
    # NOTE: no head_dim fallback for K/V — contracting a model-sharded
    # head_dim in the score einsum would force a (B,S,H,S)-sized
    # all-reduce per KV block.  Small-KV archs replicate K/V heads.
    (r"(attn|xattn)/w[kv]$",    [(-2, "model"), (-3, "data")]),
    (r"(attn|xattn)/wo$",       [(-3, "model"), (-1, "data")]),
    # dense / shared MLP
    (r"mlp/w_(gate|up)$",       [(-1, "model"), (-2, "data")]),
    (r"mlp/w_down$",            [(-2, "model"), (-1, "data")]),
    # MoE — expert dim first (EP), then d_ff (TP), then FSDP
    (r"moe/router$",            [(-1, "model"), (-2, "data")]),
    (r"moe/w_(gate|up)$",       [(-3, "model"), (-1, "model"),
                                 (-2, "data")]),
    (r"moe/w_down$",            [(-3, "model"), (-2, "model"),
                                 (-1, "data")]),
    # rwkv6 time-mix / channel-mix (flat block: layers/wr etc.)
    (r"layers/w[rkvg]$",        [(-1, "model"), (-2, "data")]),
    (r"layers/wo$",             [(-2, "model"), (-1, "data")]),
    (r"layers/ck$",             [(-1, "model"), (-2, "data")]),
    (r"layers/cv$",             [(-2, "model"), (-1, "data")]),
    (r"layers/cr$",             [(-1, "model"), (-2, "data")]),
    (r"decay_[ab]$",            []),
    # hymba SSM branch
    (r"ssm/w_in$",              [(-1, "model"), (-2, "data")]),
    (r"ssm/w_out$",             [(-2, "model"), (-1, "data")]),
    (r"ssm/w_bc$",              [(-2, "data")]),
    (r"ssm/w_dt2?$",            [(-2, "data")]),
    # everything else (norms, mu, decay_base, bonus_u, a_log, d_skip):
    # replicated — they are O(d_model) vectors.
]

Entry = Optional[object]          # None, an axis name, or a tuple of names


class PartitionSpec(tuple):
    """Per-dim mesh axes of one leaf: ``None``, an axis name, or a tuple
    of names.  A one-name tuple is stored as the bare name, as the
    reference's ``PartitionSpec`` stores it, so the two compare equal as
    tuples entry by entry."""

    def __new__(cls, *parts: Entry) -> "PartitionSpec":
        def norm(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return p[0] if len(p) == 1 else p
            return p
        return super().__new__(cls, tuple(norm(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices or a process
    group: what the rule table reads."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved mesh-axis sizes + the rule table (swappable)."""

    mesh: Any                     # a DeviceMesh or a MeshShape
    rules: Sequence[Tuple[str, List[Tuple[int, str]]]] = tuple(PARAM_RULES)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(mesh_key(self.mesh))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    names = dict(mesh_key(mesh))
    return tuple(a for a in ("pod", "data") if a in names)


def to_placements(spec: Sequence[Entry], mesh) -> Tuple[Placement, ...]:
    """One placement per mesh dimension, in mesh order: ``Shard(d)`` where
    tensor dim ``d`` names that axis (alone or in a tuple), else
    ``Replicate()``.  ``("pod", "data")`` on one dim is ``Shard(d)`` on
    both of those mesh dims."""
    out: List[Placement] = []
    for name, _ in mesh_key(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def dtensor_placements(placements: Sequence[Placement],
                       mesh) -> Tuple[Placement, ...]:
    """``placements`` as DTensors on ``mesh`` take them: a shard over a
    mesh dimension of size 1 is the whole tensor, the layout of
    ``Replicate()``, and is marked so.  DTensor's propagation rules treat
    the two marks differently where the layouts are the same: they
    refuse a ``view`` that drops a sharded singleton dim (``(1, S, d)``
    as ``(S, d)``) and, in torch 2.11, one that flattens a group of dims
    whose inner dim is sharded (``einsum`` and ``bmm`` over (batch,
    heads)); every op has a rule for replicated inputs."""
    sizes = [s for _, s in mesh_key(mesh)]
    return tuple(Replicate() if size == 1 else q
                 for q, size in zip(placements, sizes))


def _apply_candidates(shape: Sequence[int], cands: List[Tuple[int, str]],
                      sizes: Dict[str, int]) -> PartitionSpec:
    spec: List[Optional[str]] = [None] * len(shape)
    used_axes = set()
    for dim, axis in cands:
        if axis not in sizes or axis in used_axes:
            continue
        if dim < -len(shape):
            continue
        if spec[dim] is not None:
            continue
        if shape[dim] % sizes[axis] != 0 or shape[dim] < sizes[axis]:
            continue
        spec[dim] = axis
        used_axes.add(axis)
    return PartitionSpec(*spec)


def partition_spec(path: str, shape: Sequence[int],
                   rules: ShardingRules) -> PartitionSpec:
    sizes = rules.axis_sizes
    for pattern, cands in rules.rules:
        if re.search(pattern, path):
            return _apply_candidates(shape, cands, sizes)
    return PartitionSpec()        # replicate by default (norm scales etc.)


def reference_path(key: str) -> str:
    """The reference's path of a port key: ``layers.3.attn.wq`` ->
    ``layers/attn/wq`` (the layer index dropped)."""
    return "/".join(p for p in key.split(".") if not p.isdigit())


def _map_leaves(tree: PyTree, fn: Callable[[str, Any], Any],
                prefix: str = "") -> PyTree:
    """``tree`` (nested dicts, keys plain or dotted) with each leaf
    replaced by ``fn(reference path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, f"{prefix}.{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(reference_path(prefix), tree)


def param_shardings(params: PyTree, rules: ShardingRules) -> PyTree:
    """Placements matching a parameter tree: the port's state dict
    (unstacked keys), or :meth:`Model.param_specs` (stacked)."""
    return _map_leaves(params, lambda path, leaf: to_placements(
        partition_spec(path, tuple(leaf.shape), rules), rules.mesh))


def _batch_dim_spec(n: int, mesh) -> Optional[Tuple[str, ...]]:
    axes = batch_axes(mesh)
    sizes = dict(mesh_key(mesh))
    # Use the largest prefix of (pod, data) that divides the batch.
    for k in range(len(axes), 0, -1):
        prod = math.prod(sizes[a] for a in axes[:k])
        if n % prod == 0 and n >= prod:
            return axes[:k]
    return None


def batch_specs(batch: PyTree, rules: ShardingRules) -> PyTree:
    """Shard every batch leaf over its leading (batch) dim."""
    mesh = rules.mesh

    def one(_, leaf):
        b = _batch_dim_spec(leaf.shape[0], mesh)
        return to_placements([b] + [None] * (len(leaf.shape) - 1), mesh)

    return _map_leaves(batch, one)


def cache_specs_sharding(cache: PyTree, rules: ShardingRules) -> PyTree:
    """KV/SSM cache placements.

    Layer caches are stacked in both packages: (L, B, W, Kh, hd) for k/v,
    (L, B, ...) for SSM states, plus the clock.  Batch goes over (pod,
    data); the KV head dim over ``model`` when divisible, else the window
    dim, else replicated.
    """
    mesh = rules.mesh
    m = dict(mesh_key(mesh)).get("model", 1)

    def one(path, leaf):
        shp = tuple(leaf.shape)
        if len(shp) == 0:                      # the step counter
            return to_placements((), mesh)
        spec: List[Any] = [None] * len(shp)
        # Leading dim is L (stacked layers) for layer caches / memory.
        bdim = 1 if len(shp) >= 2 else 0
        spec[bdim] = _batch_dim_spec(shp[bdim], mesh)
        if re.search(r"(^|/)(k|v|mk|mv)$", path) and len(shp) == 5:
            L, B, W, Kh, hd = shp
            if Kh % m == 0 and Kh >= m:
                spec[3] = "model"
            elif W % m == 0 and W >= m:
                spec[2] = "model"
        elif re.search(r"/(ssm|state)$", path) and len(shp) >= 4:
            # (L,B,d,N) or (L,B,H,n,n): shard the channel/head dim.
            if shp[2] % m == 0 and shp[2] >= m:
                spec[2] = "model"
        return to_placements(spec, mesh)

    return _map_leaves(cache, one)


def distribute_state_dict(model: nn.Module, rules: ShardingRules
                          ) -> nn.Module:
    """Replace each parameter of ``model`` by a DTensor on ``rules.mesh``
    (a ``DeviceMesh``) with its :func:`param_shardings` placements (as
    :func:`dtensor_placements` takes them), one parameter at a time, so
    that at most one parameter exists twice.  Returns ``model``."""
    named = dict(model.named_parameters())
    for name, placements in param_shardings(named, rules).items():
        owner, _, attr = name.rpartition(".")
        module = model.get_submodule(owner)
        p = named.pop(name)
        setattr(module, attr, nn.Parameter(
            distribute_tensor(p.detach(), rules.mesh, list(
                dtensor_placements(placements, rules.mesh))),
            requires_grad=p.requires_grad))
        del p
    return model
