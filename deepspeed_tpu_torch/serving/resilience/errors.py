"""Exception types of the serving resilience surface (the port's copy
of ``deepspeed_tpu/serving/resilience/errors.py``).

These are deliberately tiny and dependency-free so every layer
(engine, scheduler, pool, bench harness, tests) can raise and catch
them without import cycles.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ServingStalledError(RuntimeError):
    """``run_until_drained`` detected that no request can make progress.

    Raised instead of spinning forever when consecutive steps change
    nothing (no token emitted, no prefill advanced, no admission, no
    retirement) while work is still queued or seated. Carries a dump of
    the stuck request states so the operator sees *what* is wedged, not
    just that something is.
    """

    def __init__(self, message: str, dump: Optional[List[Dict[str, Any]]] = None):
        super().__init__(message)
        self.dump = dump or []


class InvariantViolation(AssertionError):
    """``ServingEngine.check_invariants`` found inconsistent state.

    One exception carries EVERY violation found in the sweep (not just
    the first) — under injected faults the second violation is usually
    the informative one.
    """

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        super().__init__(
            "serving invariants violated:\n  - " + "\n  - ".join(self.violations))
