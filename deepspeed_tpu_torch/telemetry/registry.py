"""Process-local metrics registry: counters, gauges, histograms (the
port's copy of ``deepspeed_tpu/telemetry/registry.py``).

``ServingMetrics``, the recompile watchdog, and the wall-clock timers
all publish here; the registry renders as Prometheus text exposition
format (``to_prometheus``) and flushes as ``(tag, value, step)``
monitor events (``publish``) so any configured sink — including the
JSONL sink — receives the same numbers.

Names use the repo's slash convention (``serving/ttft_ms``); the
Prometheus renderer sanitizes them to ``serving_ttft_ms``.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, List, Sequence, Tuple

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")

# latency-style default buckets, in ms
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                   500.0, 1000.0, 2000.0, 5000.0)


def _sanitize(name: str) -> str:
    s = _INVALID.sub("_", name)
    if s and s[0].isdigit():
        s = "_" + s
    return s


class Counter:
    """Monotonically increasing value."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        self.value += amount


class Gauge:
    """Point-in-time value; goes up and down."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Histogram:
    """Fixed-bucket histogram (cumulative, Prometheus-style)."""

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket upper bounds."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, b in enumerate(self.buckets):
            seen += self.counts[i]
            if seen >= target:
                return b
        return self.buckets[-1] if self.buckets else 0.0


class MetricsRegistry:
    """Thread-safe name → metric table with idempotent constructors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        # zero-arg callables run before every snapshot/scrape; pull-time
        # sources (tracer ring counters, sink error counts) register one
        # instead of pushing on their own hot paths
        self._collectors: List = []

    def add_collector(self, fn) -> None:
        """Register ``fn()`` to run at the top of every
        :meth:`snapshot` / :meth:`to_prometheus`, typically to copy
        externally-owned counters (tracer drops, sink write errors)
        into gauges. Idempotent per callable object."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                # a broken collector must never take down a scrape
                pass

    def _get(self, name: str, cls, *args):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, *args)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric '{name}' already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets)

    def metrics(self) -> List[object]:
        """Metric objects after running collectors — the raw view the
        fleet aggregator labels per replica instead of re-summing the
        flattened :meth:`snapshot`."""
        self._run_collectors()
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, float]:
        """Flat scalar view (histograms contribute count/sum/p50/p99)."""
        self._run_collectors()
        out: Dict[str, float] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, (Counter, Gauge)):
                out[m.name] = m.value
            elif isinstance(m, Histogram):
                out[f"{m.name}/count"] = float(m.count)
                out[f"{m.name}/sum"] = m.total
                out[f"{m.name}/p50"] = m.quantile(0.5)
                out[f"{m.name}/p99"] = m.quantile(0.99)
        return out

    def to_prometheus(self) -> str:
        """Render every metric in Prometheus text exposition format."""
        self._run_collectors()
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            name = _sanitize(m.name)
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value:g}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for i, b in enumerate(m.buckets):
                    cum += m.counts[i]
                    lines.append(f'{name}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.total:g}")
                lines.append(f"{name}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def publish(self, monitor, step: int) -> int:
        """Flush the scalar snapshot as monitor events; returns count.

        ``monitor`` is any object with the ``MonitorMaster`` interface
        (``enabled`` + ``write_events``); disabled/None monitors are a
        no-op so callers can publish unconditionally.
        """
        if monitor is None or not getattr(monitor, "enabled", False):
            return 0
        events: List[Tuple[str, float, int]] = [
            (f"telemetry/{tag}", value, step)
            for tag, value in sorted(self.snapshot().items())
        ]
        if events:
            monitor.write_events(events)
        return len(events)
