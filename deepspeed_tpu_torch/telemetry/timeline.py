"""Per-request lifecycle timelines (the port's copy of
``deepspeed_tpu/telemetry/timeline.py``).

Every :class:`~deepspeed_tpu_torch.serving.request.Request` state transition
is recorded as a timestamped event keyed by request id — submission,
rejection (with reason), admission, each prefill chunk, first token,
speculative accept counts, retirement (with reason), failure, requeue.
The store is host-side and bounded (oldest requests are evicted once
``capacity`` distinct ids have been seen) so it is always on, even
when tracing is off.

When a tracer is attached, each timeline is mirrored as a Chrome
async-nestable track (``ph`` ``b``/``n``/``e``, ``cat="request"``,
``id=request_id``) so per-request lanes render alongside the engine
step spans in Perfetto, and terminal events carry the accumulated
chunk/spec counters.

Fleet extensions: a store owned by a fleet replica carries a
``replica_id`` that is stamped onto every event's attrs, so the
router's journey stitcher can merge timelines from several stores and
still attribute each hop. ``record(..., parked=True)`` flags a request
that is parked mid-handoff (prefill done, pages not yet adopted by a
decode home) — :meth:`parked_ids` exposes those so the completeness
probe does not mistake "closed on the prefill side" for "done".
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional


class TimelineStore:
    """Bounded request-id → event-list map, mirrored into a tracer."""

    def __init__(self, capacity: int = 4096, tracer=None,
                 replica_id: Optional[int] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.tracer = tracer
        self.replica_id = replica_id
        self._lock = threading.Lock()
        # rid -> {"events": [...], "open": bool, "parked": bool}
        self._timelines: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        # open timelines pushed out by the ring before their terminal
        # event — the one way a request can go silently "complete"
        self.evicted_open = 0

    def record(self, request_id: int, event: str,
               terminal: bool = False, parked: bool = False,
               **attrs) -> None:
        now = time.perf_counter_ns()
        if self.replica_id is not None:
            attrs.setdefault("replica", self.replica_id)
        with self._lock:
            tl = self._timelines.get(request_id)
            fresh = tl is None
            if fresh:
                tl = {"events": [], "open": True, "parked": False,
                      "wall_start": time.time()}
                self._timelines[request_id] = tl
                while len(self._timelines) > self.capacity:
                    _, old = self._timelines.popitem(last=False)
                    if old["open"]:
                        self.evicted_open += 1
            tl["events"].append(
                {"event": event, "t_ns": now, "attrs": attrs or None})
            was_open = tl["open"]
            tl["parked"] = parked
            if terminal:
                tl["open"] = False
        tr = self.tracer
        if tr is not None and tr.enabled:
            track = f"req-{request_id}"
            if fresh:
                tr.async_begin("request", track, request_id, event=event,
                               **attrs)
            if not fresh or attrs:
                tr.async_instant("request", event, request_id, **attrs)
            if terminal and was_open:
                tr.async_end("request", track, request_id, event=event,
                             **attrs)

    def get(self, request_id: int) -> Optional[List[Dict[str, Any]]]:
        """Events for one request, oldest first, or None if evicted/unknown."""
        with self._lock:
            tl = self._timelines.get(request_id)
            if tl is None:
                return None
            return list(tl["events"])

    def events_of(self, request_id: int) -> List[str]:
        """Just the event names, for terse assertions."""
        tl = self.get(request_id)
        return [e["event"] for e in tl] if tl else []

    def open_ids(self) -> List[int]:
        """Request ids that never saw a terminal event — the timeline
        COMPLETENESS check the chaos harness asserts against: after a
        drain, every submitted request must have ended in a terminal
        event (finished/rejected/failed), so this must be empty. A
        non-empty result names the requests whose lifecycle was dropped
        on the floor."""
        with self._lock:
            return [rid for rid, tl in self._timelines.items()
                    if tl["open"]]

    def parked_ids(self) -> List[int]:
        """Request ids whose LAST event parked them mid-handoff.

        A prefill-side timeline ends with a terminal ``handed_off``
        only once a decode home adopts the pages; until then the
        request sits in ``pending_handoffs`` with its timeline marked
        parked. The fleet completeness probe treats parked ∪ open as
        "not done" — a request stranded between homes must not count
        as complete on either."""
        with self._lock:
            return [rid for rid, tl in self._timelines.items()
                    if tl.get("parked")]

    def is_open(self, request_id: int) -> Optional[bool]:
        """True/False for a known request id, None if evicted/unknown."""
        with self._lock:
            tl = self._timelines.get(request_id)
            return None if tl is None else bool(tl["open"])

    def __len__(self) -> int:
        with self._lock:
            return len(self._timelines)
