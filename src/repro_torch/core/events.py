"""Cluster event bus: the simulator's loop, generalized.

The original simulator hardcoded three event kinds (SUBMIT/TICK/END)
inside one ``while heap`` loop.  The dynamics subsystem
(:mod:`repro_torch.core.dynamics`) needs more — node/GPU failures, recoveries,
planned drain windows, autoscaling decisions — so the loop is now an
:class:`EventBus`: a time-ordered heap of :class:`Event` records plus a
kind -> handler dispatch table.  The simulator registers its built-in
handlers; dynamics components subscribe theirs.

Determinism contract: events are dispatched in ``(t, kind, seq)`` order.
``EventKind`` values are chosen so that, at equal timestamps, job
lifecycle events (SUBMIT, END) land first, then cluster mutations
(failures, drains, scale decisions), then the scheduling TICK — a
failure stamped at cycle time is visible to that cycle — and metric
SAMPLEs observe the post-tick state.  The relative order of the four
original kinds is unchanged, so runs without dynamics events are
byte-identical to the pre-bus simulator.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
from typing import Any, Callable, Dict, List, Optional


class EventKind(enum.IntEnum):
    """Every kind the simulator/dynamics pipeline understands.

    The integer values ARE the same-timestamp dispatch order — see the
    module docstring before renumbering anything.
    """

    SUBMIT = 0          # a job arrives and enters its tenant queue
    END = 1             # a running job completes
    NODE_FAIL = 2       # unplanned node failure (kills resident gangs)
    NODE_RECOVER = 3    # failed node returns to service
    GPU_FAIL = 4        # single-device failure (kills the resident job)
    GPU_RECOVER = 5     # failed device returns to service
    DRAIN_START = 6     # planned maintenance: stop scheduling onto nodes
    DRAIN_END = 7       # drain window closes
    SCALE_DECISION = 8  # autoscaler evaluates its demand curve
    TICK = 9            # a scheduling cycle fires
    SAMPLE = 10         # metrics sampling


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    t: float
    kind: EventKind
    seq: int                       # heap tie-breaker (push order)
    payload: Any = dataclasses.field(default=None, compare=False)


Handler = Callable[[Event], None]


class EventBus:
    """Time-ordered event heap with per-kind handler dispatch.

    ``push`` enqueues, ``pop`` dequeues in ``(t, kind, seq)`` order, and
    ``dispatch`` runs every subscribed handler in subscription order.
    ``pending(kind)`` is an O(1) per-kind counter so drivers can ask
    "anything left of this kind?" without scanning the heap (the
    simulator's pending-submission check, §3.4-style bookkeeping).
    """

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self._handlers: Dict[EventKind, List[Handler]] = {}
        self._pending: Dict[EventKind, int] = {}
        # Optional read-only telemetry tap (repro_torch.obs): called with each
        # event BEFORE its handlers, so observers see the pre-handler
        # world.  Must not push events or mutate state.
        self.tap: Optional[Handler] = None
        # The same telemetry's span recorder: each dispatch runs inside
        # an ``event`` span, and a ``loop`` span runs from its end to
        # the next dispatch.  None = untimed.
        self.obs = None

    def __len__(self) -> int:
        return len(self._heap)

    def subscribe(self, kind: EventKind, handler: Handler) -> None:
        self._handlers.setdefault(kind, []).append(handler)

    def push(self, t: float, kind: EventKind, payload: Any = None) -> Event:
        ev = Event(t=float(t), kind=kind, seq=next(self._seq),
                   payload=payload)
        heapq.heappush(self._heap, ev)
        self._pending[kind] = self._pending.get(kind, 0) + 1
        return ev

    def pop(self) -> Optional[Event]:
        if not self._heap:
            return None
        ev = heapq.heappop(self._heap)
        self._pending[ev.kind] -= 1
        return ev

    def peek(self) -> Optional[Event]:
        """Next event without removing it (the federated lockstep loop
        merges member buses by peeking every head)."""
        return self._heap[0] if self._heap else None

    def pending(self, kind: EventKind) -> int:
        return self._pending.get(kind, 0)

    def dispatch(self, event: Event) -> None:
        obs = self.obs
        if obs is None:
            if self.tap is not None:
                self.tap(event)
            for handler in self._handlers.get(event.kind, ()):
                handler(event)
            return
        obs.loop_close()
        with obs.span("event", event.kind):
            if self.tap is not None:
                self.tap(event)
            for handler in self._handlers.get(event.kind, ()):
                handler(event)
        obs.loop_open()
