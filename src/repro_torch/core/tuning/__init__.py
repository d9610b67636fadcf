"""Self-tuning subsystem: the metrics->parameters loop.

Kant's Table-1 profiles hard-code fused score weights, preemption
budgets, backfill timeouts and spillover deadlines; since the obs
subsystem (PR 7) the stack also *observes* its own GFR/JWTD/GAR/SOR
series live.  This package closes that loop:

* :mod:`~repro_torch.core.tuning.params` — :class:`ParamSpace`: bounded,
  rate-limited tunable handles over live scheduler state;
* :mod:`~repro_torch.core.tuning.manager` — :class:`TuningManager`: binds a
  space over a simulator, windows the Sample/Tick stream, drives
  :class:`~repro_torch.core.framework.api.ControllerPlugin` instances on a
  control-period cadence;
* :mod:`~repro_torch.core.tuning.controllers` — built-ins:
  :class:`HillClimbController` (guarded hill climb with hysteresis and
  revert-on-regression), :class:`StarvationEscalator` (Mamirov-style
  priority escalation), :class:`NoOpController` (parity baseline);
* :mod:`~repro_torch.core.tuning.profile` — :class:`TuningProfile`:
  serializable tuned operating points for cross-cluster warm-starts
  (Sliwko transfer direction).

See ``docs/tuning.md`` for the contract and worked examples, and
``benchmarks/tuning_bench.py`` for the acceptance gates.
"""

from .controllers import (HillClimbController, NoOpController,
                          StarvationEscalator)
from .manager import (ObjectiveWeights, TuningManager, TuningWindow,
                      frontier_objective)
from .params import (ParamChange, ParamSpace, TunableParam, bind_gsch,
                     bind_profile_weights, bind_qsch, bind_simulator)
from .profile import TuningProfile

__all__ = [
    "HillClimbController",
    "NoOpController",
    "StarvationEscalator",
    "ObjectiveWeights",
    "TuningManager",
    "TuningWindow",
    "frontier_objective",
    "ParamChange",
    "ParamSpace",
    "TunableParam",
    "bind_gsch",
    "bind_profile_weights",
    "bind_qsch",
    "bind_simulator",
    "TuningProfile",
]
