"""Low-overhead span tracer with Chrome trace-event / Perfetto export
(the port's copy of ``deepspeed_tpu/telemetry/tracer.py``).

The tracer records *host-side* spans into a bounded, lock-protected
ring buffer. It is deliberately dumb: every event is a small dict, the
clock is ``time.perf_counter_ns`` (monotonic, ns resolution), and
nesting is never tracked explicitly — Chrome's trace viewer infers
nesting of complete ("X") events from ts/dur containment per thread
track, so a span stack on the host would only add overhead.

Disabled tracers hand out a shared null span so instrumented hot paths
pay one attribute load + one method call when tracing is off.

Event kinds emitted (Chrome trace-event ``ph`` codes):

* ``X`` — complete span (``span()`` context manager / ``trace()``
  decorator), with ``ts``/``dur`` in ns internally, µs on export.
* ``i`` — instant event (``instant()``).
* ``C`` — counter sample (``counter()``).
* ``b``/``n``/``e`` — async nestable events keyed by ``(cat, id)``;
  used for per-request lifecycle tracks (``async_begin`` /
  ``async_instant`` / ``async_end``).
* ``s``/``f`` — flow start/finish (``flow()``), drawing arrows from a
  request's track into the engine-step spans that serviced it.

Fleet export: :func:`merge_chrome` renders SEVERAL tracers into one
Chrome/Perfetto document — one *process* lane per tracer (pid = fleet
position, ``process_name`` metadata from the label), all timestamps
normalized to the fleet-wide earliest event. Because the tracers share
one host ``perf_counter_ns`` clock, cross-replica ordering is exact,
and a flow pair emitted on two different tracers with the same
``(cat, id)`` renders as an arrow ACROSS process lanes — the journey
arrows the router draws at every handoff/transfer/failover boundary.
"""

from __future__ import annotations

import functools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple


class _NullSpan:
    """No-op span returned by a disabled tracer; shared singleton."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """Context manager recording one complete ("X") event on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def set(self, **attrs):
        """Attach attributes to the span (visible in the trace viewer)."""
        if self.args is None:
            self.args = {}
        self.args.update(attrs)
        return self

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        now = time.perf_counter_ns()
        args = self.args
        if exc_type is not None:
            args = dict(args) if args else {}
            args["error"] = exc_type.__name__
        self._tracer._record({
            "name": self.name, "ph": "X", "ts": self._t0,
            "dur": now - self._t0,
            "tid": threading.get_ident(), "args": args,
        })
        return False


class Tracer:
    """Thread-safe bounded span recorder.

    ``capacity`` bounds host memory: once full, the oldest events are
    overwritten (ring buffer). ``events_total`` keeps counting, so
    ``events_total > capacity`` tells you the window wrapped.
    """

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 process_name: str = "deepspeed_tpu_torch"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = enabled
        self.process_name = process_name
        self._lock = threading.Lock()
        self._buf: List[Dict[str, Any]] = []
        self._pos = 0  # next overwrite index once the buffer is full
        self.events_total = 0
        # wall-clock anchor so exports can be correlated across files
        self.epoch_ns = time.perf_counter_ns()
        self.epoch_unix = time.time()

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _record(self, ev: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        with self._lock:
            if len(self._buf) < self.capacity:
                self._buf.append(ev)
            else:
                self._buf[self._pos] = ev
                self._pos = (self._pos + 1) % self.capacity
            self.events_total += 1

    def span(self, name: str, **args):
        """Context manager timing a block: ``with tracer.span("x"): ...``"""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def trace(self, name: Optional[str] = None):
        """Decorator form of :meth:`span`."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                if not self.enabled:
                    return fn(*a, **kw)
                with self.span(label):
                    return fn(*a, **kw)
            return wrapper
        return deco

    def instant(self, name: str, **args) -> None:
        if not self.enabled:
            return
        self._record({"name": name, "ph": "i",
                      "ts": time.perf_counter_ns(),
                      "tid": threading.get_ident(),
                      "s": "t", "args": args or None})

    def counter(self, name: str, **values) -> None:
        """Counter track sample, e.g. ``counter("slots", live=3)``."""
        if not self.enabled:
            return
        self._record({"name": name, "ph": "C",
                      "ts": time.perf_counter_ns(),
                      "tid": threading.get_ident(), "args": values})

    # --- async (per-request) tracks -----------------------------------
    def async_begin(self, cat: str, name: str, aid, **args) -> None:
        self._async("b", cat, name, aid, args)

    def async_instant(self, cat: str, name: str, aid, **args) -> None:
        self._async("n", cat, name, aid, args)

    def async_end(self, cat: str, name: str, aid, **args) -> None:
        self._async("e", cat, name, aid, args)

    def _async(self, ph: str, cat: str, name: str, aid,
               args: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        self._record({"name": name, "ph": ph, "cat": cat,
                      "id": aid, "ts": time.perf_counter_ns(),
                      "tid": threading.get_ident(),
                      "args": args or None})

    def flow(self, ph: str, name: str, fid, cat: str = "flow") -> None:
        """Flow event: ``ph`` is ``"s"`` (start) or ``"f"`` (finish)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": ph, "cat": cat, "id": fid,
              "ts": time.perf_counter_ns(), "tid": threading.get_ident()}
        if ph == "f":
            ev["bp"] = "e"  # bind to enclosing slice
        self._record(ev)

    # ------------------------------------------------------------------
    # inspection / export
    # ------------------------------------------------------------------
    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around (never exported)."""
        return max(0, self.events_total - self.capacity)

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of buffered events, oldest first."""
        with self._lock:
            return self._buf[self._pos:] + self._buf[:self._pos]

    def clear(self) -> None:
        with self._lock:
            self._buf = []
            self._pos = 0
            self.events_total = 0

    def to_chrome(self) -> Dict[str, Any]:
        """Render the buffer as a Chrome trace-event JSON object.

        Timestamps are normalized to µs relative to the earliest
        buffered event; thread idents are remapped to small tids so
        Perfetto's track names stay readable.
        """
        evs = self.events()
        base = min((e["ts"] for e in evs), default=0)
        tids: Dict[int, int] = {}
        out: List[Dict[str, Any]] = []
        for ev in evs:
            tid = tids.setdefault(ev.get("tid", 0), len(tids))
            o = {"name": ev["name"], "ph": ev["ph"], "pid": 0, "tid": tid,
                 "ts": (ev["ts"] - base) / 1e3}
            if "dur" in ev:
                o["dur"] = ev["dur"] / 1e3
            for k in ("cat", "id", "s", "bp"):
                if k in ev:
                    o[k] = ev[k]
            if ev.get("args"):
                o["args"] = ev["args"]
            out.append(o)
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        for ident, tid in tids.items():
            meta.append({"name": "thread_name", "ph": "M", "pid": 0,
                         "tid": tid, "args": {"name": f"host-{tid}"}})
        return {
            "traceEvents": meta + out,
            "displayTimeUnit": "ms",
            "otherData": {
                "epoch_unix": self.epoch_unix,
                "events_total": self.events_total,
                "dropped": self.dropped,
            },
        }

    def export(self, path: str) -> int:
        """Write the Perfetto/Chrome JSON trace; returns event count."""
        trace = self.to_chrome()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# multi-process (fleet) merge
# ---------------------------------------------------------------------------
def merge_chrome(tracers: Sequence[Tuple[str, "Tracer"]]) -> Dict[str, Any]:
    """Merge several tracers into ONE Chrome trace-event document.

    ``tracers`` is an ordered ``(label, tracer)`` sequence; position in
    the sequence becomes the Perfetto *pid* and ``label`` its
    ``process_name`` — a DP fleet renders as one lane per replica (plus
    the router's own lane). Timestamps are normalized to the earliest
    event ACROSS the whole fleet: every tracer reads the same
    process-wide ``perf_counter_ns`` clock, so relative ordering
    between lanes is exact, and a flow ``s``/``f`` pair whose halves
    were recorded on two different tracers (same ``cat`` + ``id``)
    draws its arrow across the process boundary — how a request's
    handoff/transfer/failover hops stay visually connected.
    """
    snap = [(str(label), tr.events()) for label, tr in tracers]
    base = min((e["ts"] for _, evs in snap for e in evs), default=0)
    out: List[Dict[str, Any]] = []
    meta: List[Dict[str, Any]] = []
    events_total = 0
    dropped = 0
    for pid, ((label, evs), (_, tr)) in enumerate(zip(snap, tracers)):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "tid": 0, "args": {"name": label}})
        tids: Dict[int, int] = {}
        for ev in evs:
            tid = tids.setdefault(ev.get("tid", 0), len(tids))
            o = {"name": ev["name"], "ph": ev["ph"], "pid": pid,
                 "tid": tid, "ts": (ev["ts"] - base) / 1e3}
            if "dur" in ev:
                o["dur"] = ev["dur"] / 1e3
            for k in ("cat", "id", "s", "bp"):
                if k in ev:
                    o[k] = ev[k]
            if ev.get("args"):
                o["args"] = ev["args"]
            out.append(o)
        for tid in tids.values():
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": f"host-{tid}"}})
        events_total += tr.events_total
        dropped += tr.dropped
    return {
        "traceEvents": meta + out,
        "displayTimeUnit": "ms",
        "otherData": {
            "processes": {str(i): label
                          for i, (label, _) in enumerate(snap)},
            "events_total": events_total,
            "dropped": dropped,
        },
    }


def export_merged(path: str,
                  tracers: Sequence[Tuple[str, "Tracer"]]) -> int:
    """Write a :func:`merge_chrome` fleet trace; returns event count."""
    trace = merge_chrome(tracers)
    with open(path, "w") as f:
        json.dump(trace, f)
    return len(trace["traceEvents"])
