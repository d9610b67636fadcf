"""Counted loops: the hook through which the dry-run's op counter
(:class:`~repro_torch.launch.op_analysis.OpCounter`) weights the ops a
Python loop dispatches by its trip count.

The port's Python loops on the dry-run's path (``kernels/ref.py``'s WKV
steps, ``models/hymba.py``'s scan chunks, ``models/layers.py``'s
attention chunks) iterate over :func:`trip_range`.  Without an active
counter it is ``range(n)``; under one, on meta tensors, it runs one
representative iteration under :func:`counted_loop`.  This module needs
only torch, so the kernels and models that loop do not load the cost
model: the counter pushes itself onto :data:`_ACTIVE` when it is entered.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch

__all__ = ["TripRange", "active", "counted_loop", "counting", "trip_range"]


def _sequence_nr() -> int:
    """The sequence number the next autograd node will get."""
    return torch._C._autograd._get_sequence_nr()


#: The entered op counters, innermost last.
_ACTIVE: List = []


def active() -> Optional[object]:
    return _ACTIVE[-1] if _ACTIVE else None


def counting(like: torch.Tensor) -> bool:
    """True when an op counter is active and ``like`` is on the meta
    device, so that a loop may run one iteration for all."""
    return bool(_ACTIVE) and like.device.type == "meta"


@contextlib.contextmanager
def counted_loop(n: int) -> Iterator[None]:
    """Ops dispatched inside count ×``n`` (nested loops multiply), in the
    forward pass and in the backward of the autograd nodes made here.
    Without an active counter it does nothing."""
    counter = active()
    if counter is None:
        yield
        return
    prev = counter._mult
    counter._mult = prev * n
    start = _sequence_nr()
    try:
        yield
    finally:
        end = _sequence_nr()
        m = counter._mult
        counter._mult = prev
        nodes = counter._node_mult
        for s in range(start, end):
            if nodes.get(s, 1.0) < m:
                nodes[s] = m


class TripRange:
    """``range(n)``, or, while :func:`counting` ``like``, the single index
    0 with the loop body under ``counted_loop(n)``; :meth:`full` gives
    the list the plain loop would have built from the one the loop
    built, so that a stack or concatenation after it dispatches the op
    the plain loop does, at full shape."""

    def __init__(self, n: int, like: torch.Tensor) -> None:
        self.n = n
        self.counted = n > 1 and counting(like)

    def __iter__(self) -> Iterator[int]:
        if not self.counted:
            yield from range(self.n)
            return
        with counted_loop(self.n):
            yield 0

    def full(self, items: List) -> List:
        return items * self.n if self.counted else items


def trip_range(n: int, like: torch.Tensor) -> TripRange:
    return TripRange(n, like)
