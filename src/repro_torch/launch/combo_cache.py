"""Keyed memoization for (arch × shape × mesh) combo work.

The dry-run pipeline lowers and analyses the same (architecture, input
shape, mesh) combo over and over when a job's candidate parallelism
plans are enumerated — re-lowering an identical combo is pure waste.
:class:`ComboCache` is the shared memo: the dry-run keys its lowering
and analysis results on the combo tuple (the dry-run has no port in
this package yet), and :mod:`repro_torch.core.elastic.estimate` keys
derived plan tables the same way.

This module imports nothing heavy, so the elastic scheduler, its tests
and its benchmark exercise the cache through here without ever
importing a dry-run.  Hit/miss counters are first-class: the elastic
benchmark reports them as its cache-efficiency figure.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, Hashable, Optional, Tuple

__all__ = ["ComboCache", "cache_stats", "mesh_key"]

# Every live ComboCache, for telemetry pull-collection (repro_torch.obs wires
# cache_stats() into its metric registry).  Weak references: a cache's
# lifetime stays owned by its creator, not by the stats registry.
_LIVE: "weakref.WeakSet[ComboCache]" = weakref.WeakSet()


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Hit/miss/size stats of every live cache, keyed by cache name.

    Same-named caches (e.g. a fresh one per benchmark phase) collapse
    onto one key with summed counters."""
    out: Dict[str, Dict[str, int]] = {}
    for cache in list(_LIVE):
        st = cache.stats()
        agg = out.setdefault(st["name"], {"hits": 0, "misses": 0,
                                          "size": 0})
        agg["hits"] += st["hits"]
        agg["misses"] += st["misses"]
        agg["size"] += st["size"]
    return out


def mesh_key(mesh) -> Tuple[Tuple[str, int], ...]:
    """Stable cache key for a mesh: its named axes and their sizes.
    Duck-typed over any mesh with ``axis_names`` and a ``shape``
    mapping, so key construction imports no mesh library."""
    shape = mesh.shape   # Mapping[axis name, size]
    return tuple((str(name), int(shape[name])) for name in mesh.axis_names)


class ComboCache:
    """A dict-backed memo with hit/miss accounting.

    Not thread-safe (neither is the dry-run pipeline); ``clear()``
    resets both entries and counters so benchmarks can measure one
    phase in isolation.
    """

    def __init__(self, name: str = "combo") -> None:
        self.name = name
        self.hits = 0
        self.misses = 0
        self._data: Dict[Hashable, Any] = {}
        _LIVE.add(self)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._data

    # ------------------------------------------------------------------
    def get(self, key: Hashable) -> Optional[Any]:
        """Counted lookup: a present key is a hit, a missing one a miss
        (the caller is expected to compute and :meth:`put`)."""
        if key in self._data:
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: Any) -> Any:
        self._data[key] = value
        return value

    def get_or(self, key: Hashable, compute: Callable[[], Any]) -> Any:
        """Memoized call: one hit or one miss per invocation."""
        if key in self._data:
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return self.put(key, compute())

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {"name": self.name, "hits": self.hits,
                "misses": self.misses, "size": len(self._data)}

    def clear(self) -> None:
        self._data.clear()
        self.hits = 0
        self.misses = 0
