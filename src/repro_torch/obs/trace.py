"""Chrome trace-event JSON tracer (Perfetto-loadable).

Emits the `trace-event format`__ consumed by ``chrome://tracing`` and
https://ui.perfetto.dev: a flat list of events with ``ph`` (phase),
``ts`` (microseconds), ``pid``/``tid`` lanes and free-form ``args``.
Only four phases are used:

* ``B``/``E`` — begin/end of a duration span (always balanced per
  ``(pid, tid)`` lane; asserted in ``tests/test_torch_obs.py``);
* ``i`` — an instant event (failures, preemptions, reshapes);
* ``M`` — metadata naming the process/thread lanes.

__ https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU

The telemetry layer maps the two time domains onto separate pids:

* ``PID_SCHED`` — *wall-clock* scheduler spans: one span per QSCH
  cycle with synthesized sequential child spans for the measured
  pipeline phases (snapshot → queue-sort → filter → score →
  reserve-permit → bind → preempt);
* ``PID_JOBS`` — *simulated-time* job lifecycle spans: SUBMIT opens,
  END closes, with bind / interrupt / reshape instants inside;
* ``PID_CLUSTER`` — simulated-time cluster events (failures, drains,
  scale decisions, preemptions).

Mixing domains in one timeline would be meaningless; as separate
processes Perfetto renders them as independent tracks.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = ["Tracer", "PID_SCHED", "PID_JOBS", "PID_CLUSTER"]

PID_SCHED = 1     # wall-clock scheduler cycles
PID_JOBS = 2      # sim-time job lifecycle spans
PID_CLUSTER = 3   # sim-time cluster events


class Tracer:
    """Append-only trace-event buffer with balanced-span bookkeeping.

    Events are stored as compact ``(ph, name, ts, pid, tid, args)``
    tuples and materialized into trace-event dicts only at export —
    emission sits on the scheduler's per-cycle hot path (the ≤5%
    attached-overhead budget of ``chip_smoke.py``'s ``obs`` phase)."""

    def __init__(self, max_events: int = 500_000) -> None:
        self.events: List[tuple] = []
        self.max_events = int(max_events)
        self.dropped = 0
        # Open B-span names per (pid, tid) lane, for balance/finalize.
        self._open: Dict[tuple, List[str]] = {}
        self._named: set = set()

    def __len__(self) -> int:
        return len(self.events)

    # -- low-level emit ------------------------------------------------
    def _emit(self, ev: tuple) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def metadata(self, pid: int, name: str,
                 tid: Optional[int] = None) -> None:
        """Name a process (``tid=None``) or thread lane (idempotent)."""
        key = (pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self._emit(("M",
                    "process_name" if tid is None else "thread_name",
                    0, pid, tid if tid is not None else 0,
                    {"name": name}))

    def begin(self, name: str, ts_us: float, pid: int, tid: int,
              args: Optional[Dict] = None) -> None:
        self._open.setdefault((pid, tid), []).append(name)
        self._emit(("B", name, ts_us, pid, tid, args))

    def end(self, name: str, ts_us: float, pid: int, tid: int,
            args: Optional[Dict] = None) -> None:
        stack = self._open.get((pid, tid))
        if stack and stack[-1] == name:
            stack.pop()
        self._emit(("E", name, ts_us, pid, tid, args))

    def instant(self, name: str, ts_us: float, pid: int, tid: int,
                args: Optional[Dict] = None) -> None:
        self._emit(("i", name, ts_us, pid, tid, args))

    def span(self, name: str, ts_us: float, dur_us: float, pid: int,
             tid: int, args: Optional[Dict] = None) -> None:
        """A closed span as a balanced B/E pair.

        Balanced by construction, so it skips the ``_open`` stack
        entirely — the per-cycle phase spans go through here."""
        ev = self.events
        if len(ev) + 2 > self.max_events:
            self.dropped += 2
            return
        ev.append(("B", name, ts_us, pid, tid, None))
        ev.append(("E", name, ts_us + max(0.0, dur_us), pid, tid, args))

    # -- lifecycle -----------------------------------------------------
    def open_spans(self) -> Dict[tuple, List[str]]:
        """Unclosed B-spans per (pid, tid) lane (empty when balanced)."""
        return {k: list(v) for k, v in self._open.items() if v}

    def close_all(self, ts_us: float) -> int:
        """Close every open span (used at run finalize so a horizon cut
        or an unfinished job still yields a loadable, balanced trace)."""
        n = 0
        for (pid, tid), stack in list(self._open.items()):
            while stack:
                self.end(stack[-1], ts_us, pid, tid,
                         args={"closed_at_finalize": True})
                n += 1
        return n

    # -- export --------------------------------------------------------
    def to_json(self) -> Dict[str, object]:
        out = []
        for ph, name, ts, pid, tid, args in self.events:
            ev = {"ph": ph, "name": name, "ts": ts, "pid": pid,
                  "tid": tid}
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        return {"traceEvents": out,
                "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
        return path
