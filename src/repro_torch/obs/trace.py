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

* ``PID_SCHED`` — *wall-clock* program spans (cycle, its phases, RSCH,
  the seam, events, collections), nested at their true times.  They are
  kept on ``time.perf_counter_ns`` in memory and written on the Unix
  epoch, the time base of ``torch.profiler``'s events, through a clock
  anchor (:func:`clock_anchor`) taken when the tracer is attached, so a
  program trace lines up with a device trace of the same run;
* ``PID_JOBS`` — *simulated-time* job lifecycle spans: SUBMIT opens,
  END closes, with bind / interrupt / reshape instants inside;
* ``PID_CLUSTER`` — simulated-time cluster events (failures, drains,
  scale decisions, preemptions).

Mixing domains in one timeline would be meaningless; as separate
processes Perfetto renders them as independent tracks.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "PID_SCHED", "PID_JOBS", "PID_CLUSTER", "clock_anchor"]

PID_SCHED = 1     # wall-clock program spans
PID_JOBS = 2      # sim-time job lifecycle spans
PID_CLUSTER = 3   # sim-time cluster events


def clock_anchor(tries: int = 5) -> Tuple[int, int]:
    """One instant read on both clocks: ``(time.time_ns(),
    time.perf_counter_ns())``.  The perf reading is the midpoint of two
    taken around the epoch one, from the tightest of ``tries`` tries."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, unix, (a + b) // 2)
    return best[1], best[2]


#: Fields of one event in ``Tracer.events``: ph, name, ts, pid, tid, args.
EVENT_FIELDS = 6
#: Fields of one wall event in ``Tracer.wall``: ph, name, perf_counter
#: ns, tid, cycle, key, value (an E event's args dict in ``value``).
WALL_FIELDS = 7


class Tracer:
    """Append-only trace-event buffer with balanced-span bookkeeping.

    Events are stored flat, ``EVENT_FIELDS`` list entries each, and
    materialized into trace-event dicts only at export: no tuple is kept
    for the garbage collector to scan —
    emission sits on the scheduler's per-cycle hot path (the ≤5%
    attached-overhead budget of ``chip_smoke.py``'s ``obs`` phase)."""

    def __init__(self, max_events: int = 500_000) -> None:
        self.events: List = []
        self.max_events = int(max_events)
        self.dropped = 0
        # Open B-span names per (pid, tid) lane, for balance/finalize.
        self._open: Dict[tuple, List[str]] = {}
        self._named: set = set()
        # Wall spans on the scheduler lane, ``WALL_FIELDS`` flat entries
        # an event, converted to the epoch at export.
        self.wall: List = []
        self.anchor()

    def __len__(self) -> int:
        return len(self.events) // EVENT_FIELDS

    def _stored(self) -> int:
        return (len(self.events) // EVENT_FIELDS
                + len(self.wall) // WALL_FIELDS)

    def anchor(self) -> None:
        """Take the clock anchor that converts wall spans to the epoch."""
        unix, perf = clock_anchor()
        self.epoch_offset_ns = unix - perf
        #: the epoch offset's change from this anchor to the last
        #: :meth:`measure_drift` (made at every export)
        self.drift_ns = 0

    def measure_drift(self) -> int:
        """Read the clocks again: how far the epoch has moved against
        ``perf_counter_ns`` since the anchor, in ns."""
        unix, perf = clock_anchor()
        self.drift_ns = unix - perf - self.epoch_offset_ns
        return self.drift_ns

    # -- low-level emit ------------------------------------------------
    def _emit(self, ev: tuple) -> None:
        if self._stored() >= self.max_events:
            self.dropped += 1
            return
        self.events += ev

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
            if not stack:
                del self._open[pid, tid]
        self._emit(("E", name, ts_us, pid, tid, args))

    def instant(self, name: str, ts_us: float, pid: int, tid: int,
                args: Optional[Dict] = None) -> None:
        self._emit(("i", name, ts_us, pid, tid, args))

    def span(self, name: str, ts_us: float, dur_us: float, pid: int,
             tid: int, args: Optional[Dict] = None) -> None:
        """A closed span as a balanced B/E pair (balanced by
        construction, so it skips the ``_open`` stack)."""
        if self._stored() + 2 > self.max_events:
            self.dropped += 2
            return
        self.events += ("B", name, ts_us, pid, tid, None,
                        "E", name, ts_us + max(0.0, dur_us), pid, tid, args)

    def wall_begin(self, name: str, t_ns: int, tid: int,
                   cycle: Optional[int], key: Optional[str], value) -> bool:
        """Open a wall span at ``t_ns`` (``perf_counter_ns``), of cycle
        ``cycle``, with ``value`` under ``key``; False when the cap
        dropped it, and then its end must not be written."""
        if self._stored() >= self.max_events:
            self.dropped += 2
            return False
        self.wall += ("B", name, t_ns, tid, cycle, key, value)
        return True

    def wall_end(self, name: str, t_ns: int, tid: int,
                 args: Optional[Dict] = None) -> None:
        """Close the wall span ``wall_begin`` opened (written past the
        cap, so that every lane stays balanced)."""
        self.wall += ("E", name, t_ns, tid, None, None, args)

    def wall_events(self):
        """Each wall event as ``(ph, name, perf_counter_ns, tid, args)``,
        an enum value named by its name."""
        w = self.wall
        for i in range(0, len(w), WALL_FIELDS):
            ph, name, t, tid, cycle, key, value = w[i:i + WALL_FIELDS]
            if ph == "E":
                yield ph, name, t, tid, value
                continue
            args = {}
            if cycle is not None:
                args["cycle"] = cycle
            if key is not None:
                args[key] = getattr(value, "name", value)
            yield ph, name, t, tid, args or None

    def wall_spans(self) -> List[Tuple[str, int, int]]:
        """Every closed wall span as ``(name, start_ns, end_ns)`` on the
        Unix epoch in nanoseconds, the profiler's time base."""
        off = self.epoch_offset_ns
        open_: Dict[int, List[tuple]] = {}
        out = []
        for ph, name, t, tid, _ in self.wall_events():
            stack = open_.setdefault(tid, [])
            if ph == "B":
                stack.append((name, t))
            elif stack:
                name, t0 = stack.pop()
                out.append((name, t0 + off, t + off))
        return out

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
        evs = self.events
        for i in range(0, len(evs), EVENT_FIELDS):
            ph, name, ts, pid, tid, args = evs[i:i + EVENT_FIELDS]
            ev = {"ph": ph, "name": name, "ts": ts, "pid": pid,
                  "tid": tid}
            if ph == "i":
                ev["s"] = "t"
            if args:
                ev["args"] = args
            out.append(ev)
        self.measure_drift()
        off = self.epoch_offset_ns
        for ph, name, t, tid, args in self.wall_events():
            ev = {"ph": ph, "name": name, "ts": (t + off) / 1e3,
                  "pid": PID_SCHED, "tid": tid}
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
