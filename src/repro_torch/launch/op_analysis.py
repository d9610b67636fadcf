"""Loop-weighted analysis of the aten ops a step dispatches: the
counterpart of the reference package's ``launch/hlo_analysis.py``.

Torch has no HLO.  The reference parses the compiled, partitioned XLA
text; this module counts the aten ops a step dispatches while it runs
under :class:`OpCounter`, a ``TorchDispatchMode``, on meta tensors (no
memory, no kernel).  Function by function:

* ``HloModule``        -> :class:`OpCounter`, which accumulates while the
  step runs instead of parsing it afterwards;
* ``Cost``             -> :class:`Cost` (with ``matmul_flops`` beside the
  total);
* ``top_contributors`` -> :func:`top_contributors`, the heaviest ops by
  weighted cost, labelled by aten op, result type and the innermost
  ``repro_torch`` frame (``file:function:line``) in place of jax's
  ``op_name``;
* ``analyse_hlo_text`` -> :func:`analyse_ops`, the same four keys plus
  ``matmul_flops_per_device``;
* ``known_trip_count`` -> :func:`counted_loop`: ops dispatched inside it
  count ×n.  The port's Python loops on the dry-run's path run one
  representative iteration under it (:func:`trip_range`).  Both live in
  :mod:`repro_torch.loops`, which needs only torch, so that the kernels
  and models that loop do not load this module; they are imported back
  here.

The XLA-text parsing (``_parse``, ``_split_operands``, ``_fusion_bytes``,
``_sliced_read_bytes``, the ``promoted`` all-reduce rule) has no torch
counterpart: there is no text, no fusion and no promotion to undo.

Counting rules, all on **local** tensors:

* **Per device.**  An op on a ``DTensor`` is deferred (``NotImplemented``)
  to DTensor, which dispatches each rank's local ops, and those are
  counted: rank 0's, the one the process is.  DTensor's sharding
  propagation runs each op once more on ``FakeTensor``s at the global
  shape, the first time it meets a placement; an op with a
  ``FakeTensor`` argument is run and not counted, so a count does not
  depend on that cache.  (``FlopCounterMode`` around DTensors counts the
  global work, not one device's.)
* **FLOPs.**  Matmul-class ops (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolutions, SDPA) count what ``torch.utils.flop_counter``'s formula
  says, 2·|out|·K; elementwise ops and reductions count |out|, for the
  aten counterparts of the reference's ``_ELEMENTWISE_FLOP`` and the
  fused elementwise ops eager torch has (``silu``, ``softplus``,
  ``_softmax``, ``addcmul``, their backwards).
* **Bytes.**  Each op counts its tensor operands' bytes plus its
  outputs', a broadcast (stride-0) dim once.  Views (``_unsafe_view``
  too), ``detach``, ``alias``, allocations without a write and metadata
  ops count 0 (the reference's ``_NO_TRAFFIC``).  A gather (``index``,
  ``index_select``, ``gather``, ``embedding``) counts 2×|out|, the rows
  it reads and writes, not its table; an in-place write into a slice
  (``copy_`` into a view, ``index_put_``, ``slice_scatter``) counts
  2×|update| (the reference's ``gather`` and ``dynamic-update-slice``
  rules).  This is *eager* traffic, what the
  port's step moves op by op, not the reference's count at fusion
  boundaries, so the bytes are reported beside the reference's and
  never held equal to them.
* **Collectives.**  ``_c10d_functional`` ops map to the reference's five
  ``COLLECTIVE_KINDS`` by per-device operand bytes (a ``broadcast`` is
  point to point, a ``collective-permute``); ``wait_tensor`` counts 0.
* **Memory.**  The bytes of every storage the mode's ops allocate are
  live from the op that makes them until the storage is freed
  (``weakref.finalize``); :attr:`OpCounter.peak_bytes` is their peak,
  the step's outputs included (eager torch holds them).  A counted loop
  holds one step's temporaries where the plain loop may hold all of
  them, so the peak is a lower bound there.
* **Backward.**  An op dispatched while autograd runs the backward of a
  node made inside a counted loop counts ×n too: the loop records the
  sequence numbers of the nodes its body makes.  The gradient sums of a
  plain loop's repeated slices (``select_backward`` then ``add``) are
  not repeated, so a counted loop's backward is exact for matmuls and a
  lower bound for the elementwise ops and bytes.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# The loop hook, imported back so that this module's users reach it here.
from ..loops import _ACTIVE, counted_loop, counting, trip_range

__all__ = ["COLLECTIVE_KINDS", "Cost", "OpCounter", "analyse_ops",
           "counted_loop", "counting", "top_contributors", "trip_range"]

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

#: ``_c10d_functional`` op name -> the reference's collective kind.
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")

#: Ops that move no bytes: metadata, allocation without a write, and the
#: wrappers around a collective's result.
_NO_TRAFFIC = {
    "detach", "alias", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_wrap_tensor_autograd",
    "wait_tensor", "_local_scalar_dense", "_unsafe_view",
}

#: Gathers read only the rows they return: 2×|out| (the reference's rule
#: for ``gather`` and ``dynamic-slice``), not the table they index.
_GATHERS = {"index", "index_select", "gather", "embedding"}

#: The aten counterparts of the reference's ``_ELEMENTWISE_FLOP``, and
#: eager torch's fused elementwise ops: each counts |out|.
_ELEMENTWISE_FLOP = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "exp", "tanh",
    "log", "rsqrt", "sqrt", "pow", "neg", "abs", "sign", "floor", "ceil",
    "cos", "sin", "sigmoid", "where", "clamp", "clamp_min", "clamp_max",
    "eq", "ne", "lt", "le", "gt", "ge", "logical_and", "logical_or",
    "logical_not", "logical_xor", "bitwise_and", "bitwise_or",
    "bitwise_not", "bitwise_xor", "sum", "mean", "amax", "amin", "max",
    "min", "prod", "cumsum", "_to_copy", "expm1", "log1p", "atan2",
    "remainder", "fmod", "reciprocal", "square",
    # fused elementwise ops and their backwards
    "silu", "softplus", "_softmax", "_log_softmax", "addcmul", "addcdiv",
    "lerp", "silu_backward", "softplus_backward", "sigmoid_backward",
    "tanh_backward", "_softmax_backward_data", "_log_softmax_backward_data",
    "threshold_backward",
}

#: In-place writes into a slice, by the position of the update among the
#: op's arguments: 2×|update| (read and write the window).
_SLICE_WRITES = {"index_put_": 2, "slice_scatter": 1, "select_scatter": 1}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    matmul_flops: float = 0.0

    def __iadd__(self, other: "Cost") -> "Cost":
        self.flops += other.flops
        self.bytes += other.bytes
        self.matmul_flops += other.matmul_flops
        for k in COLLECTIVE_KINDS:
            self.coll[k] += other.coll[k]
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m,
                    {k: v * m for k, v in self.coll.items()},
                    self.matmul_flops * m)

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll.values())


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses: a broadcast
    (stride-0) dim counts once."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


_TYPE_NAMES = {torch.float32: "f32", torch.float64: "f64",
               torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
               torch.int8: "s8", torch.uint8: "u8"}


def _type_str(t: torch.Tensor) -> str:
    """``bf16[16,1024]``, as the reference prints a result type."""
    return (_TYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
            + str(list(t.shape)).replace(" ", ""))


_THIS_FILE = os.path.abspath(__file__)
_PORT_DIR = os.path.dirname(os.path.dirname(_THIS_FILE)) + os.sep


def _site() -> str:
    """The innermost frame in the port's package, but this module:
    ``models/layers.py:chunked_attention:182``."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PORT_DIR) and name != _THIS_FILE:
            return (f"{name[len(_PORT_DIR):]}:{f.f_code.co_name}:"
                    f"{f.f_lineno}")
        f = f.f_back
    return "?"


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective bytes of the local aten ops
    dispatched inside it, each weighted by the trip counts of the
    :func:`counted_loop` s around it.

    ``sites=True`` labels each op by its innermost ``repro_torch`` frame
    for :func:`top_contributors` (a frame walk per op: the profile's
    cost, not the dry-run's).  ``device="meta"`` counts only ops on meta
    tensors, which is what a dry-run's step dispatches: DTensor's
    redistribution planner computes the shard sizes of a
    ``_StridedShard`` by splitting index tensors on the host, which the
    program does not run."""

    def __init__(self, *, sites: bool = False,
                 device: Optional[str] = None) -> None:
        super().__init__()
        self.device = device
        self.cost = Cost()
        self.raw = Cost()                   # each dispatch once, unweighted
        self.rows: Dict[Tuple[str, str, str], Cost] = {}
        self.sites = sites
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}     # storage id -> bytes
        self.read_storages: set = set()     # read here, made before the mode
        self._mult = 1.0
        self._node_mult: Dict[int, float] = {}

    # -- mode stack ------------------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    # -- memory ------------------------------------------------------------
    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _forget(self, key: int) -> None:
        self.read_storages.discard(key)

    def _track(self, inputs: Sequence[torch.Tensor],
               outputs: Sequence[torch.Tensor]) -> None:
        for t in inputs:
            s = t.untyped_storage()
            key = s._cdata
            if key not in self._live and key not in self.read_storages:
                self.read_storages.add(key)
                weakref.finalize(s, self._forget, key)
        for t in outputs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._live or key in self.read_storages:
                continue
            n = s.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(s, self._release, key)

    # -- counting ------------------------------------------------------------
    def _weight(self) -> float:
        m = self._mult
        if self._node_mult:
            node = torch._C._current_autograd_node()
            if node is not None:
                m *= self._node_mult.get(node._sequence_nr(), 1.0)
        return m

    def _cost(self, func, inputs, outputs, args, kwargs, out) -> Cost:
        schema = func._schema
        ns, _, name = schema.name.partition("::")
        c = Cost()
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                c.coll[kind] = float(sum(_nbytes(t) for t in inputs))
                c.bytes = float(sum(_nbytes(t) for t in inputs + outputs))
            return c
        if name in _NO_TRAFFIC:
            return c
        packet = func.overloadpacket
        if packet in flop_registry:
            c.matmul_flops = float(flop_registry[packet](
                *args, **kwargs, out_val=out))
            c.flops = c.matmul_flops
        elif name.rstrip("_") in _ELEMENTWISE_FLOP:
            c.flops = float(sum(t.numel() for t in outputs))
        rets = schema.returns
        if rets and rets[0].alias_info is not None \
                and not rets[0].alias_info.is_write:
            return c                                      # a view
        if name in _GATHERS:
            c.bytes = 2.0 * sum(_nbytes(t) for t in outputs)
        elif name in _SLICE_WRITES:
            c.bytes = 2.0 * _nbytes(args[_SLICE_WRITES[name]])
        elif name == "copy_" and args[0]._is_view():
            c.bytes = 2.0 * _nbytes(args[1])
        else:
            c.bytes = float(sum(_nbytes(t) for t in inputs + outputs))
        return c

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        inputs = [a for a in tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor)]
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor) for t in inputs):
            return out                    # DTensor's sharding propagation
        outputs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if self.device is not None and not any(
                t.device.type == self.device for t in inputs + outputs):
            return out
        c = self._cost(func, inputs, outputs, args, kwargs, out)
        self.raw += c
        m = self._weight()
        if m != 1.0:
            c = c.scaled(m)
        self.cost += c
        if c.flops or c.bytes or c.collective_bytes:
            key = (str(func.overloadpacket).replace("aten.", ""),
                   _type_str(outputs[0]) if outputs else "",
                   _site() if self.sites else "")
            row = self.rows.get(key)
            if row is None:
                self.rows[key] = c
            else:
                row += c
        self._track(inputs, [o for o in outputs
                             if not any(o is t for t in inputs)])
        return out

    # -- result ------------------------------------------------------------
    def summary(self) -> Dict[str, object]:
        return {"flops_per_device": self.cost.flops,
                "bytes_per_device": self.cost.bytes,
                "collective_bytes_per_device": self.cost.collective_bytes,
                "collectives": dict(self.cost.coll),
                "matmul_flops_per_device": self.cost.matmul_flops}


def analyse_ops(fn: Callable, *args, **kwargs) -> Dict[str, object]:
    """``fn(*args, **kwargs)`` run once under a fresh :class:`OpCounter`:
    the reference's four keys (``flops_per_device``,
    ``bytes_per_device``, ``collective_bytes_per_device``,
    ``collectives``) and ``matmul_flops_per_device``."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.summary()


def top_contributors(counter: OpCounter, metric: str = "flops",
                     n: int = 20) -> List[Tuple[float, str, str, str]]:
    """The dry-run 'profile': the heaviest ops by weighted cost, as
    ``[(value, aten op, result type, site), ...]``; ``metric`` is
    ``"flops"``, ``"bytes"`` or ``"coll"``.  Rows sum every call of one
    op at one site with one result type."""
    get = {"flops": lambda c: c.flops, "bytes": lambda c: c.bytes,
           "coll": lambda c: c.collective_bytes}[metric]
    rows = [(get(c), op, rtype, site)
            for (op, rtype, site), c in counter.rows.items() if get(c) > 0]
    rows.sort(key=lambda r: -r[0])
    return rows[:n]

