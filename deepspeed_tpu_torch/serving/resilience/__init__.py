"""Fault-tolerant serving: the robustness surface over the serving
engine (the port's copy of ``deepspeed_tpu/serving/resilience/``).

The reference framework ships elasticity, retry/abort launcher paths
and checkpoint recovery; this package is the serving-side equivalent,
built as four coupled pieces the engine hooks into:

* request lifecycle hardening — per-request deadlines, a per-step
  wall-time watchdog, and a NaN/inf logits guard that fails only the
  poisoned slot (``engine.py`` hooks; reasons in ``request.py``);
* preemption — ``ServingEngine.preempt`` plus the automatic
  youngest/lowest-progress victim policy (:mod:`.preemption`);
* graceful degradation — the HEALTHY/PRESSURED/OVERLOADED load-state
  machine (:mod:`.degradation`);
* deterministic fault injection — seeded, schedulable failures at
  named engine points, for the chaos suite (:mod:`.faults`).
"""

from .degradation import (DegradationConfig, LoadState,  # noqa: F401
                          LoadStateMachine)
from .errors import InvariantViolation, ServingStalledError  # noqa: F401
from .faults import (POINTS, FaultInjectingDrafter,  # noqa: F401
                     FaultInjector, InjectedFault)
from .preemption import select_victims  # noqa: F401

__all__ = ["DegradationConfig", "LoadState", "LoadStateMachine",
           "InvariantViolation", "ServingStalledError", "POINTS",
           "FaultInjector", "FaultInjectingDrafter", "InjectedFault",
           "select_victims"]
