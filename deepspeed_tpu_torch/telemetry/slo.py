"""Streaming SLO / goodput accounting: O(1)-memory quantile digests,
per-window goodput counters, and multi-window burn-rate alerting (the
port's copy of ``deepspeed_tpu/telemetry/slo.py``).

ROADMAP item 2 wants the async front end benched on *goodput under
SLO*, not raw throughput. The sensors for that live here:

* :class:`QuantileDigest` — an HDR-histogram-style log-bucketed
  estimator: fixed memory, bounded *relative* error (midpoint of a
  geometric bucket is within ``rel_error`` of any value in it), and
  mergeable by adding bucket counts. p50/p90/p99 therefore come from a
  stream without retaining samples — unlike the post-hoc numpy
  percentiles ``ServingMetrics.snapshot`` computes from full lists.
* :class:`WindowedQuantiles` — a ring of K sub-digests; the serving
  loop rotates every ``window_steps`` steps, so quantiles reflect a
  sliding window, not process lifetime.
* :class:`SLOTracker` — judges each finished request against
  :class:`SLOConfig` targets (TTFT / inter-token gap / e2e, per
  priority class), maintains per-window goodput (requests finished
  within SLO ÷ admitted), and derives SRE-style multi-window burn
  rates: ``burn = (1 - goodput) / (1 - goodput_target)`` over a short
  (last 2 windows) and long (all windows) horizon. Alert state is
  ``page`` when both horizons burn ≥ ``page_burn``, ``warn`` when both
  ≥ ``warn_burn``, else ``ok`` — requiring both horizons suppresses
  one-window blips while still paging fast on sustained burn. The same
  two-horizon formula runs PER PRIORITY CLASS over per-class window
  rings (``class_alert``) — that is the signal the serving front end's
  burn-rate-driven shedding/preemption consumes.

Everything exports through the existing sinks: registry gauges (hence
Prometheus), Perfetto counter tracks, and monitor events on alert
transitions.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

_ALERT_LEVELS = {"ok": 0, "warn": 1, "page": 2}


class QuantileDigest:
    """Log-bucketed streaming quantile estimator (HDR-histogram style).

    Values are assigned to geometric buckets growing by
    ``1 + 2 * rel_error``; a quantile is answered as the geometric
    midpoint of the bucket holding that rank, clamped to the observed
    min/max — so the estimate's relative error is bounded by
    ``rel_error`` regardless of the distribution's shape. Memory is a
    fixed ``O(log(max/min) / rel_error)`` int array; merging two
    digests with identical parameters is elementwise addition.
    """

    __slots__ = ("min_value", "max_value", "rel_error", "_log_growth",
                 "_growth", "_nbuckets", "counts", "count", "_vmin",
                 "_vmax")

    def __init__(self, min_value: float = 1e-2, max_value: float = 1e7,
                 rel_error: float = 0.01):
        if not (0 < min_value < max_value):
            raise ValueError(f"need 0 < min_value < max_value, got "
                             f"{min_value}, {max_value}")
        if not (0 < rel_error < 0.5):
            raise ValueError(f"rel_error must be in (0, 0.5), got "
                             f"{rel_error}")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.rel_error = float(rel_error)
        self._growth = 1.0 + 2.0 * rel_error
        self._log_growth = math.log(self._growth)
        self._nbuckets = int(math.ceil(
            math.log(max_value / min_value) / self._log_growth)) + 1
        self.counts = [0] * self._nbuckets
        self.count = 0
        self._vmin = math.inf
        self._vmax = 0.0

    def _bucket(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        i = int(math.log(v / self.min_value) / self._log_growth)
        return i if i < self._nbuckets else self._nbuckets - 1

    def add(self, value: float, n: int = 1) -> None:
        v = float(value)
        if math.isnan(v):
            return
        if v < 0.0:
            v = 0.0
        self.counts[self._bucket(v)] += n
        self.count += n
        if v < self._vmin:
            self._vmin = v
        if v > self._vmax:
            self._vmax = v

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank:
                est = self.min_value * self._growth ** (i + 0.5)
                return min(max(est, self._vmin), self._vmax)
        return self._vmax

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        if (other.min_value, other.max_value, other.rel_error) != \
                (self.min_value, self.max_value, self.rel_error):
            raise ValueError("cannot merge digests with different "
                             "bucket parameters")
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.count += other.count
        self._vmin = min(self._vmin, other._vmin)
        self._vmax = max(self._vmax, other._vmax)
        return self

    def clear(self) -> None:
        for i in range(self._nbuckets):
            self.counts[i] = 0
        self.count = 0
        self._vmin = math.inf
        self._vmax = 0.0


class WindowedQuantiles:
    """Ring of ``windows`` sub-digests; :meth:`rotate` seals the
    current window and recycles the oldest, so :meth:`quantile`
    (computed over the merged ring) is a sliding-window view."""

    def __init__(self, windows: int = 8, **digest_kw):
        if windows < 1:
            raise ValueError(f"windows must be >= 1, got {windows}")
        self._kw = dict(digest_kw)
        self._ring: List[QuantileDigest] = [
            QuantileDigest(**self._kw) for _ in range(windows)]
        self._cur = 0

    @property
    def windows(self) -> int:
        return len(self._ring)

    @property
    def count(self) -> int:
        return sum(d.count for d in self._ring)

    def add(self, value: float, n: int = 1) -> None:
        self._ring[self._cur].add(value, n)

    def rotate(self) -> None:
        self._cur = (self._cur + 1) % len(self._ring)
        self._ring[self._cur].clear()

    def merged(self) -> QuantileDigest:
        out = QuantileDigest(**self._kw)
        for d in self._ring:
            if d.count:
                out.merge(d)
        return out

    def quantile(self, q: float) -> float:
        return self.merged().quantile(q)


@dataclasses.dataclass
class SLOTargets:
    """Latency targets for one priority class, in milliseconds.
    ``None`` disables that criterion."""
    ttft_ms: Optional[float] = 500.0
    gap_ms: Optional[float] = 200.0     # mean inter-token gap
    e2e_ms: Optional[float] = None


def _targets_from(value: Any) -> SLOTargets:
    if isinstance(value, SLOTargets):
        return value
    return SLOTargets(**dict(value or {}))


@dataclasses.dataclass
class SLOConfig:
    """SLO targets per priority class plus windowing/alert policy.

    ``resolve`` accepts the serving-knob forms: ``True`` (defaults), an
    ``SLOConfig``, or a dict — top-level ``ttft_ms``/``gap_ms``/
    ``e2e_ms`` keys configure the ``default`` class, a ``classes`` dict
    adds per-priority targets, and the remaining keys map to config
    fields."""

    classes: Dict[str, SLOTargets] = dataclasses.field(
        default_factory=lambda: {"default": SLOTargets()})
    goodput_target: float = 0.95       # SLO objective; error budget base
    warn_burn: float = 2.0
    page_burn: float = 10.0
    window_steps: int = 128            # serving steps per digest window
    windows: int = 8
    digest_rel_error: float = 0.01

    @classmethod
    def resolve(cls, value: Any) -> Optional["SLOConfig"]:
        if value is None or value is False:
            return None
        if value is True:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            kw = dict(value)
            default = {k: kw.pop(k) for k in ("ttft_ms", "gap_ms", "e2e_ms")
                       if k in kw}
            classes = {name: _targets_from(t)
                       for name, t in kw.pop("classes", {}).items()}
            if default or "default" not in classes:
                base = classes.get("default", SLOTargets())
                classes["default"] = dataclasses.replace(base, **default)
            return cls(classes=classes, **kw)
        raise TypeError(f"cannot resolve SLOConfig from {value!r}")


class SLOTracker:
    """Judges request completions against SLO targets and maintains
    windowed goodput + burn-rate alert state. Fed by the serving loop:
    ``observe_admitted`` on accepted submission, ``observe_gap`` per
    decode step, ``observe_finish`` per completed request, ``on_step``
    once per step (rotation + export)."""

    def __init__(self, config: Any = True, registry=None, tracer=None,
                 monitor=None):
        self.config = SLOConfig.resolve(config) or SLOConfig()
        cfg = self.config
        dk = dict(min_value=1e-2, max_value=1e7,
                  rel_error=cfg.digest_rel_error)
        self.ttft = WindowedQuantiles(cfg.windows, **dk)
        self.gap = WindowedQuantiles(cfg.windows, **dk)
        self.e2e = WindowedQuantiles(cfg.windows, **dk)
        self.registry = registry
        self.tracer = tracer
        self.monitor = monitor
        # per-window [admitted, finished-within-SLO] counters
        self._gw: List[List[int]] = [[0, 0] for _ in range(cfg.windows)]
        self._gw_cur = 0
        self.admitted_total = 0
        self.finished_total = 0
        self.good_total = 0
        self.per_class: Dict[str, List[int]] = {}
        # per-class windowed counters, same ring layout as _gw, created
        # lazily per class — these drive the PER-CLASS burn rates the
        # priority scheduler's shedding/preemption loop consumes
        self._cw: Dict[str, List[List[int]]] = {}
        self.class_alerts: Dict[str, str] = {}
        self.class_burns: Dict[str, List[float]] = {}  # cls -> [short, long]
        self.cancelled_total = 0
        self.alert_state = "ok"
        self.burn_short = 0.0
        self.burn_long = 0.0
        self.rotations = 0
        self._steps_in_window = 0
        self._p99_cache: Dict[str, float] = {}
        self.overhead_ns = 0
        self._handles = None            # cached registry metric objects

    # -- feeds ---------------------------------------------------------
    def _class_targets(self, cls: str) -> SLOTargets:
        return self.config.classes.get(cls) \
            or self.config.classes.get("default") or SLOTargets()

    def _class_window(self, cls: str) -> List[List[int]]:
        cw = self._cw.get(cls)
        if cw is None:
            cw = self._cw[cls] = [[0, 0]
                                  for _ in range(self.config.windows)]
        return cw

    def observe_admitted(self, cls: str = "default") -> None:
        self.admitted_total += 1
        self._gw[self._gw_cur][0] += 1
        self.per_class.setdefault(cls, [0, 0, 0])[0] += 1
        self._class_window(cls)[self._gw_cur][0] += 1

    def observe_cancel(self, cls: str = "default") -> None:
        """Un-admit a cancelled request: client cancellation (or
        disconnect) is neither good nor bad service, so it must not
        move goodput either way. The admitted counters are decremented
        where the admission still sits; if the admitting window has
        already rotated out, the decrement lands in the current window
        instead — a bounded, self-correcting artifact (each such cancel
        offsets at most one admission of the same class, and windows
        are short relative to request lifetimes)."""
        self.cancelled_total += 1
        self._gw[self._gw_cur][0] = max(0, self._gw[self._gw_cur][0] - 1)
        if self.admitted_total > 0:
            self.admitted_total -= 1
        pc = self.per_class.setdefault(cls, [0, 0, 0])
        pc[0] = max(0, pc[0] - 1)
        cw = self._class_window(cls)[self._gw_cur]
        cw[0] = max(0, cw[0] - 1)

    def observe_gap(self, gap_s: float) -> None:
        t0 = time.perf_counter_ns()
        self.gap.add(gap_s * 1e3)
        self.overhead_ns += time.perf_counter_ns() - t0

    def observe_finish(self, ttft_s: Optional[float] = None,
                       per_token_s: Optional[float] = None,
                       e2e_s: Optional[float] = None,
                       cls: str = "default", ok: bool = True) -> bool:
        """Record a completed request; returns whether it met its SLO.
        ``ok=False`` (deadline expiry, failure) makes the request count
        against goodput regardless of its latencies — a fast failure is
        not good service."""
        t0 = time.perf_counter_ns()
        t = self._class_targets(cls)
        within = bool(ok)
        if ttft_s is not None:
            self.ttft.add(ttft_s * 1e3)
        if t.ttft_ms is not None:
            within = within and (ttft_s is not None
                                 and ttft_s * 1e3 <= t.ttft_ms)
        if e2e_s is not None:
            self.e2e.add(e2e_s * 1e3)
        if t.e2e_ms is not None:
            within = within and (e2e_s is not None
                                 and e2e_s * 1e3 <= t.e2e_ms)
        if t.gap_ms is not None and per_token_s is not None:
            within = within and per_token_s * 1e3 <= t.gap_ms
        self.finished_total += 1
        pc = self.per_class.setdefault(cls, [0, 0, 0])
        pc[1] += 1
        if within:
            self.good_total += 1
            self._gw[self._gw_cur][1] += 1
            pc[2] += 1
            self._class_window(cls)[self._gw_cur][1] += 1
        else:
            self._class_window(cls)  # materialize the ring so the class
            #                          shows up in burn/alert maps
        self.overhead_ns += time.perf_counter_ns() - t0
        return within

    # -- derived state -------------------------------------------------
    @staticmethod
    def _goodput_of(pairs) -> float:
        admitted = sum(p[0] for p in pairs)
        good = sum(p[1] for p in pairs)
        return good / admitted if admitted else 1.0

    def goodput(self) -> float:
        """Sliding-window goodput: finished-within-SLO ÷ admitted."""
        return self._goodput_of(self._gw)

    def window_counts(self) -> Dict[str, List[List[int]]]:
        """Raw ``[admitted, good]`` window pairs for fleet merging.

        ``short`` is the two-window burn horizon (current + previous),
        ``all`` the full ring. A fleet aggregator sums the pairs
        ACROSS replicas and runs the same :meth:`_burn` formula on the
        merged counts — mathematically identical to one tracker having
        observed every request, which averaging per-replica burn rates
        is not (replicas with 2 requests would weigh as much as ones
        with 2000)."""
        prev_i = (self._gw_cur - 1) % self.config.windows
        return {
            "short": [list(self._gw[self._gw_cur]), list(self._gw[prev_i])],
            "all": [list(p) for p in self._gw],
        }

    def _burn(self, goodput: float) -> float:
        budget = max(1e-9, 1.0 - self.config.goodput_target)
        return max(0.0, 1.0 - goodput) / budget

    def _alert_of(self, burn_short: float, burn_long: float) -> str:
        cfg = self.config
        if burn_short >= cfg.page_burn and burn_long >= cfg.page_burn:
            return "page"
        if burn_short >= cfg.warn_burn and burn_long >= cfg.warn_burn:
            return "warn"
        return "ok"

    def _recompute_alert(self) -> None:
        cfg = self.config
        prev_i = (self._gw_cur - 1) % cfg.windows
        self.burn_short = self._burn(
            self._goodput_of([self._gw[self._gw_cur], self._gw[prev_i]]))
        self.burn_long = self._burn(self.goodput())
        state = self._alert_of(self.burn_short, self.burn_long)
        self._last_state_change = state != self.alert_state
        self.alert_state = state
        # per-class burns, same two-horizon formula over the class rings
        for cls, cw in self._cw.items():
            short = self._burn(
                self._goodput_of([cw[self._gw_cur], cw[prev_i]]))
            long = self._burn(self._goodput_of(cw))
            self.class_burns[cls] = [short, long]
            self.class_alerts[cls] = self._alert_of(short, long)

    def class_alert(self, cls: str) -> str:
        """Current burn-rate alert for one class (``ok`` when the class
        has never been observed)."""
        return self.class_alerts.get(cls, "ok")

    def _rotate(self) -> None:
        self.ttft.rotate()
        self.gap.rotate()
        self.e2e.rotate()
        self._gw_cur = (self._gw_cur + 1) % self.config.windows
        self._gw[self._gw_cur] = [0, 0]
        for cw in self._cw.values():
            cw[self._gw_cur] = [0, 0]
        self.rotations += 1
        self._steps_in_window = 0
        # quantile walks are O(buckets x windows); amortize them to
        # rotation boundaries so the per-step cost stays counters-only
        self._p99_cache = {
            "ttft_p99_ms": self.ttft.quantile(0.99),
            "gap_p99_ms": self.gap.quantile(0.99),
            "e2e_p99_ms": self.e2e.quantile(0.99),
        }

    def on_step(self, step: int = 0) -> None:
        """Once per serving step: window rotation, burn-rate/alert
        recompute, gauge + Perfetto counter export."""
        t0 = time.perf_counter_ns()
        self._steps_in_window += 1
        if self._steps_in_window >= self.config.window_steps:
            self._rotate()
        prev_state = self.alert_state
        self._recompute_alert()
        gp = self.goodput()
        level = _ALERT_LEVELS[self.alert_state]
        if self.registry is not None:
            if self._handles is None:
                # one registry (lock-taking) lookup per metric, ever
                g = self.registry.gauge
                self._handles = (g("slo/goodput"), g("slo/burn_short"),
                                 g("slo/burn_long"), g("slo/alert_level"),
                                 g("slo/ttft_p99_ms"), g("slo/gap_p99_ms"),
                                 g("slo/e2e_p99_ms"))
            h = self._handles
            h[0].set(gp)
            h[1].set(self.burn_short)
            h[2].set(self.burn_long)
            h[3].set(level)
            pc = self._p99_cache
            if pc:
                h[4].set(pc["ttft_p99_ms"])
                h[5].set(pc["gap_p99_ms"])
                h[6].set(pc["e2e_p99_ms"])
        if self.tracer is not None:
            self.tracer.counter("slo/goodput", goodput=gp,
                                burn_short=self.burn_short)
            self.tracer.counter("slo/alert", level=level)
        if self.alert_state != prev_state:
            if self.tracer is not None:
                self.tracer.instant("slo/alert_change",
                                    state=self.alert_state,
                                    burn_short=self.burn_short,
                                    burn_long=self.burn_long)
            if self.monitor is not None \
                    and getattr(self.monitor, "enabled", False):
                self.monitor.write_events([
                    ("telemetry/slo_alert", float(level), int(step))])
        self.overhead_ns += time.perf_counter_ns() - t0

    # -- lifecycle -----------------------------------------------------
    def reset(self) -> None:
        """Zero all windows/counters (keep config); benches call this
        after warmup so goodput covers only the measured interval."""
        for wq in (self.ttft, self.gap, self.e2e):
            for d in wq._ring:
                d.clear()
        self._gw = [[0, 0] for _ in range(self.config.windows)]
        self._gw_cur = 0
        self.admitted_total = 0
        self.finished_total = 0
        self.good_total = 0
        self.per_class = {}
        self._cw = {}
        self.class_alerts = {}
        self.class_burns = {}
        self.cancelled_total = 0
        self.alert_state = "ok"
        self.burn_short = 0.0
        self.burn_long = 0.0
        self.rotations = 0
        self._steps_in_window = 0
        self._p99_cache = {}
        self.overhead_ns = 0

    @property
    def overhead_s(self) -> float:
        return self.overhead_ns / 1e9

    def snapshot(self) -> Dict[str, Any]:
        ttft, gap, e2e = (self.ttft.merged(), self.gap.merged(),
                          self.e2e.merged())
        return {
            "goodput_slo": self.goodput(),
            "admitted": self.admitted_total,
            "finished": self.finished_total,
            "good": self.good_total,
            "burn_short": self.burn_short,
            "burn_long": self.burn_long,
            "alert_state": self.alert_state,
            "ttft_p50_ms": ttft.quantile(0.5),
            "ttft_p90_ms": ttft.quantile(0.9),
            "ttft_p99_ms": ttft.quantile(0.99),
            "gap_p50_ms": gap.quantile(0.5),
            "gap_p90_ms": gap.quantile(0.9),
            "gap_p99_ms": gap.quantile(0.99),
            "e2e_p99_ms": e2e.quantile(0.99),
            "cancelled": self.cancelled_total,
            "per_class": {
                k: {"admitted": v[0], "finished": v[1], "good": v[2],
                    "goodput_window": (self._goodput_of(self._cw[k])
                                       if k in self._cw else 1.0),
                    "burn_short": self.class_burns.get(k, [0.0, 0.0])[0],
                    "burn_long": self.class_burns.get(k, [0.0, 0.0])[1],
                    "alert": self.class_alerts.get(k, "ok")}
                for k, v in sorted(self.per_class.items())},
            "rotations": self.rotations,
            "windows": self.config.windows,
            "window_steps": self.config.window_steps,
            "overhead_s": self.overhead_s,
        }
