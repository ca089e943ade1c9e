"""Crash flight recorder: a bounded ring of per-step serving records
plus self-contained post-mortem dumps (the port's copy of
``deepspeed_tpu/telemetry/flight_recorder.py``).

``ServingEngine.step`` appends one small dict per step (step id, load
state, queue depth, grants, slot/page occupancy, wall, alert state) —
a deque append, ~zero cost. When the engine is about to raise one of
its fatal conditions (``InvariantViolation``, ``ServingStalledError``,
strict ``RecompileAfterWarmupError``) it asks the recorder for a
post-mortem: the last N step records, every still-open request
timeline, a registry snapshot, the tail of the tracer ring, and the
triggering error — one JSON file that answers "what was the engine
doing when it died" without logs, sinks, or a live process.

``srv.debug_dump()`` returns the same structure live (a /statusz
equivalent); the dump file only adds the reason/error envelope.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Dict, List, Optional

SCHEMA_VERSION = 1

# keys every persisted post-mortem carries; pinned by tests so external
# tooling can rely on the file shape
POST_MORTEM_KEYS = ("schema_version", "reason", "error", "time_unix",
                    "steps", "records_total", "open_timelines",
                    "registry", "last_spans", "extra")


def _json_default(obj: Any):
    """Last-resort coercion for numpy scalars and friends."""
    try:
        return float(obj)
    except Exception:
        return str(obj)


class FlightRecorder:
    """Bounded ring of per-step records with post-mortem export."""

    def __init__(self, capacity: int = 256,
                 dump_dir: Optional[str] = None,
                 last_spans: int = 64):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.last_spans = int(last_spans)
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=self.capacity)
        self.records_total = 0
        self.dumps: List[str] = []          # paths written, in order
        self.dump_failures = 0

    # -- hot path ------------------------------------------------------
    def record(self, rec: Dict[str, Any]) -> None:
        self._ring.append(rec)
        self.records_total += 1

    def last(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        steps = list(self._ring)
        return steps if n is None else steps[-n:]

    @property
    def dump_count(self) -> int:
        return len(self.dumps)

    # -- snapshots -----------------------------------------------------
    def snapshot(self, timelines=None, registry=None,
                 tracer=None) -> Dict[str, Any]:
        """Live statusz view: ring + open timelines + registry + span
        tail. Same payload a post-mortem wraps."""
        open_timelines: Dict[str, Any] = {}
        if timelines is not None:
            try:
                for rid in timelines.open_ids():
                    open_timelines[str(rid)] = timelines.get(rid) or []
            except Exception:
                pass
        spans: List[Dict[str, Any]] = []
        if tracer is not None and getattr(tracer, "enabled", False):
            try:
                spans = tracer.events()[-self.last_spans:]
            except Exception:
                pass
        return {
            "schema_version": SCHEMA_VERSION,
            "steps": self.last(),
            "records_total": self.records_total,
            "open_timelines": open_timelines,
            "registry": registry.snapshot() if registry is not None else {},
            "last_spans": spans,
        }

    def post_mortem(self, reason: str, error: Any = None,
                    timelines=None, registry=None, tracer=None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        pm = self.snapshot(timelines=timelines, registry=registry,
                           tracer=tracer)
        pm.update(reason=reason,
                  error=repr(error) if error is not None else None,
                  time_unix=time.time(),
                  extra=extra or {})
        return pm

    def dump(self, reason: str, error: Any = None, timelines=None,
             registry=None, tracer=None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write a post-mortem JSON under ``dump_dir``; returns the
        path, or None when no dump_dir is configured. Never raises —
        the caller is already unwinding the real failure."""
        if not self.dump_dir:
            return None
        pm = self.post_mortem(reason, error=error, timelines=timelines,
                              registry=registry, tracer=tracer,
                              extra=extra)
        step = pm["steps"][-1]["step_id"] if pm["steps"] else 0
        fname = (f"postmortem-{len(self.dumps):03d}-step{step}-"
                 f"{reason}.json")
        path = os.path.join(self.dump_dir, fname)
        try:
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(pm, f, indent=1, default=_json_default)
        except Exception:
            self.dump_failures += 1
            return None
        self.dumps.append(path)
        return path
