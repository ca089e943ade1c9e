"""Admission queue + slot-grant policy for continuous batching (the port's
copy of ``deepspeed_tpu/serving/scheduler.py``, without the stall-free token
budget and the paged-KV page budget, which arrive with those slices).

Host-only: the scheduler owns the FIFO queue, enforces admission control
(bounded depth, prompt + budget fits the KV capacity) and decides which
queued requests take a slot this step. Two policies:

* ``"continuous"``: every step, any free slot is refilled from the queue
  (iteration-level scheduling, Orca).
* ``"gang"``: the static-batch discipline of ``generate()``: admit only
  when the pool has fully drained, then seat a whole batch at once.
"""

from __future__ import annotations

import collections
from typing import Deque, List, Optional, Tuple

from .request import RejectReason, Request, RequestState

POLICIES = ("continuous", "gang")


class FIFOScheduler:
    """Bounded FIFO admission queue with a slot-grant policy."""

    def __init__(self, num_slots: int, max_queue_depth: int = 64,
                 policy: str = "continuous", capacity: Optional[int] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES}")
        self.num_slots = num_slots
        self.max_queue_depth = max_queue_depth
        self.policy = policy
        self.capacity = capacity
        self.queue: Deque[Request] = collections.deque()

    @property
    def pending(self) -> int:
        return len(self.queue)

    def submit(self, req: Request) -> Tuple[bool, Optional[RejectReason]]:
        """Admission control: ``(accepted, reject_reason)``. The capacity
        check covers the request's whole footprint (prompt + budget)."""
        if self.capacity is not None and \
                req.seed_len + req.max_new_tokens - len(req.output_tokens) \
                > self.capacity:
            return False, RejectReason.PROMPT_TOO_LONG
        if len(self.queue) >= self.max_queue_depth:
            return False, RejectReason.QUEUE_FULL
        req.state = RequestState.QUEUED
        self.queue.append(req)
        return True, None

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put granted-but-never-admitted requests back at the head,
        keeping their relative order."""
        for r in reversed(reqs):
            r.state = RequestState.QUEUED
            self.queue.appendleft(r)

    def grant(self, free_slots: int, live_slots: int) -> List[Request]:
        """Pop the requests that take a slot this step."""
        if self.policy == "gang" and live_slots > 0:
            return []  # batch-synchronous: wait for the gang to drain
        granted: List[Request] = []
        while self.queue and len(granted) < free_slots:
            granted.append(self.queue.popleft())
        return granted
