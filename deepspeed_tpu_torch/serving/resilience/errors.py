"""Serving error types (the port's copy of ``deepspeed_tpu/serving/
resilience/errors.py``)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class ServingStalledError(RuntimeError):
    """``run_until_drained`` saw no progress for too many steps while work
    was queued or seated; carries a dump of the stuck requests."""

    def __init__(self, message: str,
                 dump: Optional[List[Dict[str, Any]]] = None):
        super().__init__(message)
        self.dump = dump or []


class InvariantViolation(AssertionError):
    """``ServingEngine.check_invariants`` found inconsistent state; carries
    every violation found in the sweep."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        super().__init__(
            "serving invariants violated:\n  - "
            + "\n  - ".join(self.violations))
