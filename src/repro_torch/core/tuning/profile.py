"""TuningProfile: a serializable tuned operating point.

The transfer unit of the Sliwko direction: a named parameter dict (the
``ParamSpace.snapshot()`` of a tuned stack) plus the objective it
reached and free-form provenance metadata.  Export one from a tuned
trace or federation member, ship it as JSON, and warm-start another
member's :class:`~repro_torch.core.tuning.manager.TuningManager` from it —
the receiver force-applies the parameter *intersection*, so profiles
transfer between differently-shaped clusters (unknown handles are
reported, not fatal).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional


@dataclasses.dataclass
class TuningProfile:
    name: str
    #: ParamSpace handle name -> tuned value.
    params: Dict[str, float]
    #: Frontier objective at export time (None = never measured).
    objective: Optional[float] = None
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TuningProfile":
        d = json.loads(text)
        return cls(name=d["name"],
                   params={str(k): float(v)
                           for k, v in d["params"].items()},
                   objective=(None if d.get("objective") is None
                              else float(d["objective"])),
                   meta=dict(d.get("meta", {})))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "TuningProfile":
        with open(path) as f:
            return cls.from_json(f.read())
