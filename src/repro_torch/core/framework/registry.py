"""Plugin registry: name -> factory.

Built-in and contrib plugins self-register at import; out-of-tree code
registers with the same decorator, then profiles can be assembled from
names (useful for config-driven profile construction)::

    from repro_torch.core.framework import register, create_plugin

    @register
    class MyScore(ScorePlugin):
        name = "MyScore"
        ...

    plugin = create_plugin("MyScore", weight=2.0)
"""

from __future__ import annotations

import difflib
from typing import Callable, Dict, List, Type

from .api import Plugin

_REGISTRY: Dict[str, Callable[..., Plugin]] = {}


def register(cls: Type[Plugin]) -> Type[Plugin]:
    """Class decorator: register a plugin type under its ``name``."""
    name = getattr(cls, "name", None) or cls.__name__
    existing = _REGISTRY.get(name)
    if existing is not None and existing is not cls:
        raise ValueError(
            f"plugin name {name!r} already registered by {existing!r}")
    _REGISTRY[name] = cls
    return cls


def create_plugin(name: str, **params) -> Plugin:
    """Instantiate a registered plugin by name.

    Unknown names raise :class:`KeyError` (kept for backward
    compatibility) whose message lists the sorted registered names plus
    the closest matches to the requested one — a typo like
    ``"BinPackScore"`` points straight at ``"BinpackScore"``.
    """
    try:
        factory = _REGISTRY[name]
    except KeyError:
        names = available_plugins()
        close = difflib.get_close_matches(name, names, n=3, cutoff=0.6)
        hint = f" (did you mean {close}?)" if close else ""
        raise KeyError(f"unknown plugin {name!r}{hint}; "
                       f"registered: {names}") from None
    return factory(**params)


def available_plugins() -> List[str]:
    return sorted(_REGISTRY)
