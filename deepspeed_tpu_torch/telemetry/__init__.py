"""Telemetry (the port of ``deepspeed_tpu/telemetry/``): structured
tracing, per-request timelines, the recompile watchdog, a
Prometheus-exportable metrics registry, streaming SLO/goodput accounting
and the crash flight recorder.

* :class:`Tracer` — host-side spans into a bounded ring, exported as a
  Chrome trace-event / Perfetto JSON timeline. A span around a CUDA call
  times its host dispatch (the card runs behind the host), as a JAX span
  times dispatch.
* :class:`MetricsRegistry` — counters, gauges and histograms rendered as
  Prometheus text (:meth:`MetricsRegistry.to_prometheus`) and flushed as
  ``(tag, value, step)`` monitor events (:meth:`MetricsRegistry.publish`).
* :class:`TimelineStore` — per-request lifecycle events, mirrored as
  async tracks into the tracer.
* :class:`RecompileWatchdog` — new signatures of the serving engine's
  entry points and every decode capture after warmup.
* :class:`SLOTracker` — windowed quantile digests, goodput and
  burn-rate alerts per priority class.
* :class:`FlightRecorder` — a ring of per-step records that becomes a
  post-mortem JSON when the engine raises, and ``debug_dump()`` live.

* :class:`ProgramCostModel` — analytic flops and bytes per serving
  program and signature, charged per call through the watchdog's proxies:
  live MFU, bandwidth utilization and tokens per GFLOP against the card's
  published peaks (:func:`resolve_peaks`), and the KV footprint
  reconciled against the pool (:func:`kv_hbm_report`,
  :func:`device_memory_report`).

* :class:`FleetTelemetry` — the fleet edition: every replica's registry
  merged into one Prometheus exposition with ``replica=``/``role=``
  labels, digests merged bucketwise, goodput over summed windows, and ONE
  fleet post-mortem when a replica dies (``ReplicaRouter.fleet``).

Serving integration (all knobs on ``deepspeed_tpu_torch.init_serving``)::

    srv = dst.init_serving(model, tracer=Tracer(), strict_recompile=True,
                           cost_model=True)
    srv.end_warmup()            # after warmup traffic
    srv.timeline(request_id)    # per-request lifecycle events
    srv.publish_telemetry()     # registry -> monitor sinks
    srv.efficiency_snapshot()   # MFU, bandwidth share, KV drift, overhead
"""

from .tracer import Tracer, export_merged, merge_chrome
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .timeline import TimelineStore
from .watchdog import (RecompileAfterWarmupError, RecompileWatchdog,
                       abstract_signature, fast_key, fast_signature,
                       suppress_compile_events)
from .slo import (QuantileDigest, SLOConfig, SLOTargets, SLOTracker,
                  WindowedQuantiles)
from .flight_recorder import FlightRecorder, POST_MORTEM_KEYS
from .costs import (ProgramCostModel, device_memory_report, kv_hbm_report,
                    resolve_peaks)
from .fleet import (FleetTelemetry, FLEET_POST_MORTEM_KEYS,
                    FLEET_SCHEMA_VERSION)

__all__ = [
    "Tracer",
    "merge_chrome",
    "export_merged",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "TimelineStore",
    "RecompileWatchdog",
    "RecompileAfterWarmupError",
    "abstract_signature",
    "fast_key",
    "fast_signature",
    "suppress_compile_events",
    "QuantileDigest",
    "WindowedQuantiles",
    "SLOConfig",
    "SLOTargets",
    "SLOTracker",
    "FlightRecorder",
    "POST_MORTEM_KEYS",
    "FleetTelemetry",
    "FLEET_POST_MORTEM_KEYS",
    "FLEET_SCHEMA_VERSION",
    "ProgramCostModel",
    "resolve_peaks",
    "kv_hbm_report",
    "device_memory_report",
]
