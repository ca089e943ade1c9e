"""Deterministic fault injection for the serving engine (the port's copy
of ``deepspeed_tpu/serving/resilience/faults.py``; ``corrupt_logits``
writes its NaN row on the device, in place).

Chaos testing only proves anything if a failing run can be REPLAYED:
the injector is therefore fully deterministic — every injection point
draws from its own seeded generator (stream identity keyed by a stable
CRC of the point name, never by Python's salted ``hash``), and an
explicit ``schedule`` can pin faults to exact call ordinals ("fail the
3rd admission") independent of wall clock. The engine threads one
injector through its hot path at five named points:

``admit_oom``
    raised inside ``_admit``/``_admit_batch`` after the slot is taken,
    before any request state is committed — exercises the PR-2
    admission rollback (slot returned, request re-queued at the head).
``drafter_error``
    raised from the drafter's ``propose`` (via
    :class:`FaultInjectingDrafter`) — exercises the exception-safe
    step abort with speculative decoding enabled.
``nan_logits``
    overwrites ONE live slot's decode logits row with NaN — exercises
    the per-slot numerics guard (only the poisoned request fails).
``step_host_error``
    raised on the host between admission and decode — exercises the
    mid-step abort path while requests are RUNNING.
``slow_dispatch``
    sleeps ``slow_ms`` inside the step — exercises the step wall-time
    watchdog and the load-state machine's latency signal.
``state_corruption``
    fires at the step boundary; the engine responds by deliberately
    corrupting its own slot bookkeeping (a seated slot marked free, or
    a free slot leaked) — exercises the ``check_invariants()`` audit
    and the flight-recorder post-mortem path with REAL corruption, the
    one failure class the other points are designed never to cause.

A point that raises uses :class:`InjectedFault` (a ``RuntimeError``
subclass) so harnesses can catch *injected* failures precisely while
real bugs still propagate.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: every injection point the engine threads the injector through
POINTS = ("admit_oom", "drafter_error", "nan_logits", "step_host_error",
          "slow_dispatch", "state_corruption")


class InjectedFault(RuntimeError):
    """An exception raised on purpose by a :class:`FaultInjector`."""

    def __init__(self, point: str, nth: int):
        super().__init__(f"injected fault at '{point}' (call #{nth})")
        self.point = point
        self.nth = nth


class FaultInjector:
    """Seeded, replayable fault source with named injection points.

    Two firing modes compose per point:

    * ``schedule={point: [call ordinals]}`` — fire on exactly those
      1-based calls of the point (the chaos bench's fixed schedule);
    * ``rates={point: p}`` — fire each call with probability ``p`` from
      the point's own seeded stream (soak testing).

    ``counts``/``fired`` expose per-point call and fire totals so a
    harness can assert every scheduled fault actually landed.
    """

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 schedule: Optional[Dict[str, Iterable[int]]] = None,
                 slow_ms: float = 2.0):
        self.seed = int(seed)
        if slow_ms < 0:
            raise ValueError(f"slow_ms must be >= 0, got {slow_ms}")
        self.slow_ms = float(slow_ms)
        self.rates: Dict[str, float] = {}
        for point, rate in (rates or {}).items():
            self._check_point(point)
            if not 0.0 <= float(rate) <= 1.0:
                raise ValueError(f"rate for '{point}' must be in [0, 1], "
                                 f"got {rate}")
            self.rates[point] = float(rate)
        self.schedule: Dict[str, set] = {}
        self.counts: Dict[str, int] = {p: 0 for p in POINTS}
        self.fired: Dict[str, int] = {p: 0 for p in POINTS}
        # one independent deterministic stream per point: firing order at
        # one point can never perturb another point's draws
        self._rngs = {p: np.random.default_rng(
            (self.seed, zlib.crc32(p.encode()))) for p in POINTS}
        if schedule:
            self.load_schedule(schedule, reset_counts=False)

    @staticmethod
    def _check_point(point: str) -> None:
        if point not in POINTS:
            raise ValueError(f"unknown injection point '{point}'; expected "
                             f"one of {POINTS}")

    # ------------------------------------------------------------------
    def load_schedule(self, schedule: Dict[str, Iterable[int]],
                      reset_counts: bool = True) -> None:
        """(Re)arm the ordinal schedule — e.g. keep the injector quiet
        through warmup, then load the measured run's fault plan."""
        armed: Dict[str, set] = {}
        for point, ordinals in schedule.items():
            self._check_point(point)
            armed[point] = {int(n) for n in ordinals}
            if any(n < 1 for n in armed[point]):
                raise ValueError(f"schedule ordinals are 1-based; got "
                                 f"{sorted(armed[point])} for '{point}'")
        self.schedule = armed
        if reset_counts:
            self.counts = {p: 0 for p in POINTS}

    def _roll(self, point: str) -> bool:
        self._check_point(point)
        self.counts[point] += 1
        hit = self.counts[point] in self.schedule.get(point, ())
        rate = self.rates.get(point, 0.0)
        if rate:
            # always consume the draw so the stream stays aligned
            # whether or not the schedule already fired this call
            hit = bool(self._rngs[point].random() < rate) or hit
        if hit:
            self.fired[point] += 1
        return hit

    # -- the point APIs the engine calls -------------------------------
    def check(self, point: str) -> None:
        """Raise :class:`InjectedFault` if ``point`` fires this call."""
        if self._roll(point):
            raise InjectedFault(point, self.counts[point])

    def fires(self, point: str) -> bool:
        """Non-raising roll: returns whether ``point`` fires this call.
        For points whose effect the CALLER applies (state_corruption)."""
        return self._roll(point)

    def maybe_sleep(self, point: str = "slow_dispatch") -> bool:
        """Sleep ``slow_ms`` if ``point`` fires; returns whether it did."""
        if self._roll(point):
            time.sleep(self.slow_ms / 1e3)
            return True
        return False

    def corrupt_logits(self, logits: Any, rows: Sequence[int]
                       ) -> Tuple[Any, Optional[int]]:
        """Poison one row of a (num_slots, ...) logits batch with NaN.

        ``rows`` are the LIVE slot ids (dead slots are padding nobody
        reads — poisoning them would test nothing). Returns the
        (possibly corrupted) logits and the poisoned slot id, or
        ``(logits, None)`` when the point does not fire.

        The row is written in place on the logits' device through a
        host integer index: no host round trip, no new tensor and no
        new shape, so the step's one fetch and the captured decode
        graph (whose next replay overwrites its output) are
        untouched."""
        if not rows or not self._roll("nan_logits"):
            return logits, None
        pick = int(self._rngs["nan_logits"].integers(len(rows)))
        slot = int(rows[pick])
        logits[slot] = float("nan")
        return logits, slot

    def summary(self) -> Dict[str, Dict[str, int]]:
        return {"counts": dict(self.counts), "fired": dict(self.fired)}


class FaultInjectingDrafter:
    """Drafter wrapper that threads the ``drafter_error`` point through
    ``propose`` — the serving engine installs it around the configured
    drafter when a :class:`FaultInjector` is attached, so drafter
    failures surface exactly where a real drafter would throw (inside
    the speculative step, after admission, before verify)."""

    def __init__(self, inner: Any, injector: FaultInjector):
        self.inner = inner
        self.injector = injector

    @property
    def name(self) -> str:
        return getattr(self.inner, "name", "drafter")

    def propose(self, histories: List[Optional[np.ndarray]], k: int):
        self.injector.check("drafter_error")
        return self.inner.propose(histories, k)
