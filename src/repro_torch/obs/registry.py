"""Prometheus-style metric registry with ring-buffered time series.

Three metric types — :class:`Counter` (monotone), :class:`Gauge`
(set-to-value) and :class:`Histogram` (bucketed observations) — each
addressable by name + label set, exactly like the Prometheus data
model.  Every write also appends ``(t, value)`` to a bounded ring
buffer per labeled series, so a run keeps a live *series* (what the
ROADMAP's self-tuning controller will consume) and not just a final
scalar.

Time comes from a settable **clock**: the attached
:class:`~repro_torch.obs.telemetry.Telemetry` points it at the simulator's
event time, so series are in simulated seconds; standalone users can
leave the default 0-clock or set their own.

Exposition is dual: :meth:`MetricRegistry.expose_text` emits the
Prometheus text format (``# HELP`` / ``# TYPE`` / samples, histogram
``_bucket``/``_sum``/``_count`` with cumulative ``le`` buckets) and
:meth:`MetricRegistry.to_json` a JSON document including the ring
series — the part the text format has no room for.

Pull-model **collectors** (:meth:`MetricRegistry.add_collector`) let
subsystems that keep their own counters (serving pools, combo caches,
the dynamics engine) publish on demand: ``collect()`` runs every
registered callable right before exposition.
"""

from __future__ import annotations

import collections
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Metric", "MetricRegistry",
           "DEFAULT_BUCKETS"]

#: Default histogram bucket upper bounds (seconds-flavored, like
#: Prometheus' defaults but extended for queue-wait scales).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0,
    300.0, 900.0, 3600.0, 14400.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class _Series:
    """One labeled series: current value + bounded (t, value) ring."""

    __slots__ = ("value", "ring")

    def __init__(self, ring: int) -> None:
        self.value = 0.0
        self.ring: collections.deque = collections.deque(maxlen=ring)

    def record(self, t: float, value: float) -> None:
        self.value = value
        self.ring.append((t, value))


class Metric:
    """Base: a named family of labeled series."""

    type_name = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricRegistry"
                 ) -> None:
        self.name = name
        self.help = help
        self._registry = registry
        self._series: Dict[LabelKey, _Series] = {}

    def _get(self, labels: Dict[str, object]) -> _Series:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _Series(self._registry.ring)
            # Stable exposition order: keep insertion order per family.
        return s

    def series(self, **labels) -> List[Tuple[float, float]]:
        """The ring-buffered (t, value) series for one label set."""
        return list(self._get(labels).ring)

    def value(self, **labels) -> float:
        return self._get(labels).value

    def label_sets(self) -> List[Dict[str, str]]:
        return [dict(k) for k in self._series]

    # -- exposition ----------------------------------------------------
    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type_name}"]
        for key, s in self._series.items():
            lines.append(f"{self.name}{_fmt_labels(key)} {s.value:g}")
        return lines

    def to_json(self) -> Dict[str, object]:
        return {
            "type": self.type_name,
            "help": self.help,
            "series": [{"labels": dict(key), "value": s.value,
                        "samples": [[t, v] for t, v in s.ring]}
                       for key, s in self._series.items()],
        }


class Counter(Metric):
    """Monotone counter: ``inc`` only (negative increments rejected)."""

    type_name = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        s = self._get(labels)
        s.record(self._registry.now(), s.value + amount)


class Gauge(Metric):
    """Set-to-current-value metric."""

    type_name = "gauge"

    def set(self, value: float, **labels) -> None:
        self._get(labels).record(self._registry.now(), float(value))

    def inc(self, amount: float = 1.0, **labels) -> None:
        s = self._get(labels)
        s.record(self._registry.now(), s.value + amount)


class _HistSeries(_Series):
    __slots__ = ("counts", "sum", "count")

    def __init__(self, ring: int, n_buckets: int) -> None:
        super().__init__(ring)
        self.counts = [0] * (n_buckets + 1)   # +inf bucket last
        self.sum = 0.0
        self.count = 0


class Histogram(Metric):
    """Bucketed observations with Prometheus cumulative exposition.

    ``buckets`` are the **upper bounds** of the non-cumulative bins;
    an implicit ``+Inf`` bucket catches the tail.  Bucket assignment is
    ``value <= bound`` (Prometheus ``le`` semantics) — asserted against
    a ``np.histogram`` reference in ``tests/test_torch_obs.py``."""

    type_name = "histogram"

    def __init__(self, name: str, help: str, registry: "MetricRegistry",
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, registry)
        self.buckets: Tuple[float, ...] = tuple(sorted(float(b)
                                                       for b in buckets))

    def _get(self, labels: Dict[str, object]) -> _HistSeries:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(self._registry.ring,
                                                len(self.buckets))
        return s  # type: ignore[return-value]

    def observe(self, value: float, **labels) -> None:
        s = self._get(labels)
        value = float(value)
        i = 0
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                break
        else:
            i = len(self.buckets)
        s.counts[i] += 1
        s.sum += value
        s.count += 1
        s.record(self._registry.now(), value)

    def cumulative(self, **labels) -> List[int]:
        """Cumulative counts per ``le`` bound (+Inf last)."""
        s = self._get(labels)
        out, acc = [], 0
        for c in s.counts:
            acc += c
            out.append(acc)
        return out

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.type_name}"]
        for key, s in self._series.items():
            acc = 0
            for bound, c in zip(self.buckets, s.counts):
                acc += c
                lines.append(f"{self.name}_bucket"
                             f"{_fmt_labels(key, (('le', f'{bound:g}'),))}"
                             f" {acc}")
            acc += s.counts[-1]
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, (('le', '+Inf'),))} {acc}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} {s.sum:g}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {s.count}")
        return lines

    def to_json(self) -> Dict[str, object]:
        out = super().to_json()
        out["buckets"] = list(self.buckets)
        for entry, (key, s) in zip(out["series"], self._series.items()):
            entry["counts"] = list(s.counts)
            entry["sum"] = s.sum
            entry["count"] = s.count
        return out


class MetricRegistry:
    """Name -> metric family store with collectors and a settable clock."""

    def __init__(self, ring: int = 512,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.ring = int(ring)
        self._clock: Callable[[], float] = clock or (lambda: 0.0)
        self._metrics: Dict[str, Metric] = {}
        self._collectors: List[Callable[["MetricRegistry"], None]] = []

    # -- clock ---------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    def now(self) -> float:
        return float(self._clock())

    # -- families ------------------------------------------------------
    def _family(self, cls, name: str, help: str, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, self, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.type_name}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._family(Counter, name, help)  # type: ignore

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._family(Gauge, name, help)  # type: ignore

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._family(Histogram, name, help,  # type: ignore
                            buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return list(self._metrics)

    # -- collectors ----------------------------------------------------
    def add_collector(self, fn: Callable[["MetricRegistry"], None]
                      ) -> None:
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn(self)

    # -- exposition ----------------------------------------------------
    def expose_text(self, collect: bool = True) -> str:
        if collect:
            self.collect()
        lines: List[str] = []
        for m in self._metrics.values():
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def to_json(self, collect: bool = True) -> Dict[str, object]:
        if collect:
            self.collect()
        return {name: m.to_json() for name, m in self._metrics.items()}

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2, sort_keys=True)
