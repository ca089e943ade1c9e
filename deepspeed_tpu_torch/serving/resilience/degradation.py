"""Graceful-degradation load-state machine (the port's copy of
``deepspeed_tpu/serving/resilience/degradation.py``).

Overload handling is a LADDER, not a cliff: the state machine watches
the signals :class:`~deepspeed_tpu_torch.serving.metrics.ServingMetrics`
already collects (queue depth, rolling inter-token step-gap p99) and
walks ``HEALTHY -> PRESSURED -> OVERLOADED`` as they worsen. Each rung
trades a little quality-of-service for stability, cheapest lever
first:

* ``PRESSURED`` — shrink the per-step prefill token budget toward one
  chunk: admissions slow down, live decode slots keep their latency.
* ``OVERLOADED`` — additionally suspend speculative drafting (the
  verify program still runs, with zero proposals — same shapes, no
  recompile) and shed NEW submissions with the ``retry_after`` reject
  reason so the queue stops growing.

Escalation is immediate (overload compounds per step); de-escalation
requires ``cooldown_steps`` consecutive calmer observations so the
server doesn't flap around a threshold. Every transition is reported
to the caller, which mirrors it into monitor events, the tracer (a
counter track + instants, so Perfetto shows the ladder), and metrics.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional, Tuple


class LoadState(enum.IntEnum):
    """Ordered load levels; the int value is the monitor/trace encoding."""

    HEALTHY = 0
    PRESSURED = 1
    OVERLOADED = 2


@dataclasses.dataclass
class DegradationConfig:
    """Thresholds and dynamics of the load-state machine.

    ``queue_*`` compare against the admission queue depth;
    ``gap_p99_*_ms`` (optional) against the rolling p99 of whole-step
    inter-token gaps over the last ``window`` steps. A signal may be
    disabled by leaving its thresholds ``None``; the machine takes the
    WORST level any enabled signal reports.
    """

    queue_pressured: Optional[int] = 8
    queue_overloaded: Optional[int] = 16
    gap_p99_pressured_ms: Optional[float] = None
    gap_p99_overloaded_ms: Optional[float] = None
    window: int = 32             # step-gap samples in the rolling p99
    cooldown_steps: int = 8      # calm observations before de-escalating
    retry_after_s: float = 1.0   # hint stamped on shed requests

    @classmethod
    def from_value(cls, value: Any) -> Optional["DegradationConfig"]:
        """``None``/``False`` -> disabled, ``True`` -> defaults, dict ->
        overrides, instance -> itself."""
        if value is None or value is False:
            return None
        if value is True:
            cfg = cls()
        elif isinstance(value, cls):
            cfg = value
        elif isinstance(value, dict):
            unknown = set(value) - {f.name for f in dataclasses.fields(cls)}
            if unknown:
                raise ValueError(f"unknown degradation keys {sorted(unknown)}")
            cfg = cls(**value)
        else:
            raise TypeError(f"degradation must be None/bool/dict/"
                            f"DegradationConfig, got {type(value).__name__}")
        cfg.validate()
        return cfg

    def validate(self) -> None:
        for lo, hi, what in ((self.queue_pressured, self.queue_overloaded,
                              "queue"),
                             (self.gap_p99_pressured_ms,
                              self.gap_p99_overloaded_ms, "gap_p99")):
            if (lo is None) != (hi is None):
                raise ValueError(f"{what} thresholds must be set together "
                                 f"(got pressured={lo}, overloaded={hi})")
            if lo is not None and not 0 < lo <= hi:
                raise ValueError(f"need 0 < {what}_pressured ({lo}) <= "
                                 f"{what}_overloaded ({hi})")
        if self.queue_pressured is None and self.gap_p99_pressured_ms is None:
            raise ValueError("degradation enabled but every signal is "
                             "disabled (all thresholds None)")
        if self.window < 1 or self.cooldown_steps < 1:
            raise ValueError(f"window ({self.window}) and cooldown_steps "
                             f"({self.cooldown_steps}) must be >= 1")
        if self.retry_after_s < 0:
            raise ValueError(f"retry_after_s must be >= 0, "
                             f"got {self.retry_after_s}")


class LoadStateMachine:
    """Hysteretic HEALTHY/PRESSURED/OVERLOADED tracker (see module doc)."""

    def __init__(self, cfg: DegradationConfig):
        self.cfg = cfg
        self.state = LoadState.HEALTHY
        self._calm = 0
        # (step, old, new) history — the chaos bench reports it and the
        # tests assert the ladder was actually walked
        self.transitions: list = []

    # ------------------------------------------------------------------
    @staticmethod
    def _level(value: Optional[float], pressured: Optional[float],
               overloaded: Optional[float]) -> LoadState:
        if value is None or pressured is None:
            return LoadState.HEALTHY
        if value >= overloaded:
            return LoadState.OVERLOADED
        if value >= pressured:
            return LoadState.PRESSURED
        return LoadState.HEALTHY

    def classify(self, queue_depth: int,
                 gap_p99_ms: Optional[float]) -> LoadState:
        """Instantaneous level: the worst any enabled signal reports."""
        cfg = self.cfg
        return max(
            self._level(queue_depth, cfg.queue_pressured,
                        cfg.queue_overloaded),
            self._level(gap_p99_ms, cfg.gap_p99_pressured_ms,
                        cfg.gap_p99_overloaded_ms))

    def update(self, queue_depth: int, gap_p99_ms: Optional[float],
               step: int = 0) -> Optional[Tuple[LoadState, LoadState]]:
        """Feed one step's signals; returns ``(old, new)`` on a
        transition, ``None`` otherwise. Escalates immediately,
        de-escalates only after ``cooldown_steps`` consecutive calmer
        observations (straight to the observed level — a recovered
        server should not crawl back one rung per cooldown)."""
        desired = self.classify(queue_depth, gap_p99_ms)
        if desired > self.state:
            old, self.state = self.state, desired
            self._calm = 0
            self.transitions.append((step, old, desired))
            return (old, desired)
        if desired < self.state:
            self._calm += 1
            if self._calm >= self.cfg.cooldown_steps:
                old, self.state = self.state, desired
                self._calm = 0
                self.transitions.append((step, old, desired))
                return (old, desired)
        else:
            self._calm = 0
        return None
