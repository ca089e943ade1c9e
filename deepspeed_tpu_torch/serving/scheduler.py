"""Admission queue + slot-grant policy for continuous batching (the port's
copy of ``deepspeed_tpu/serving/scheduler.py``).

Host-only: the scheduler owns the FIFO queue, enforces admission control
(bounded depth, prompt + budget fits the KV capacity, and with paged KV
fits the page pool) and decides which queued requests take a slot this
step. Two policies:

* ``"continuous"``: every step, any free slot is refilled from the queue
  (iteration-level scheduling, Orca).
* ``"gang"``: the static-batch discipline of ``generate()``: admit only
  when the pool has fully drained, then seat a whole batch at once.

Under the serving engine's stall-free mode, ``grant`` also enforces a
per-step prefill token budget (Sarathi-style) and, with paged KV, a strict
page budget.
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, List, Optional, Tuple

from .request import RejectReason, Request, RequestState

POLICIES = ("continuous", "gang")


class FIFOScheduler:
    """Bounded FIFO admission queue with a slot-grant policy."""

    def __init__(self, num_slots: int, max_queue_depth: int = 64,
                 policy: str = "continuous", capacity: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, page_headroom: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{POLICIES}")
        self.num_slots = num_slots
        self.max_queue_depth = max_queue_depth
        self.policy = policy
        self.capacity = capacity
        # paged KV: the admission currency is pages, not rows;
        # ``page_headroom`` is extra columns charged per request
        # (speculative verify's k-past-the-length writes)
        self.page_size = page_size
        self.num_pages = num_pages
        self.page_headroom = int(page_headroom)
        self.queue: Deque[Request] = collections.deque()

    def page_footprint(self, req: Request) -> Optional[int]:
        """Worst-case pages ``req`` could ever hold (seed + remaining
        budget + headroom), or None when the pool is not paged."""
        if self.page_size is None:
            return None
        cols = (req.seed_len + req.max_new_tokens - len(req.output_tokens)
                + self.page_headroom)
        return -(-cols // self.page_size)

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
        fp = self.page_footprint(req)
        if fp is not None and self.num_pages is not None \
                and fp > self.num_pages:
            # even the whole pool, every other request preempted, could
            # never hold this request: refuse it now, not at the queue head
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

    def requeue_back(self, reqs: List[Request]) -> None:
        """Requeue at the tail: the pressure-preemption path. A victim sent
        to the head would get its own freed slot back at the next grant
        and be preempted again, forever; behind the arrivals that caused
        the pressure it time-slices with them instead."""
        for r in reqs:
            r.state = RequestState.QUEUED
            self.queue.append(r)

    def grant(self, free_slots: int, live_slots: int,
              token_budget: Optional[int] = None,
              cost: Optional[Callable[[Request], int]] = None,
              spent: int = 0, page_budget: Optional[int] = None,
              page_cost: Optional[Callable[[Request], int]] = None
              ) -> List[Request]:
        """Pop the requests that take a slot this step.

        With ``token_budget``/``cost`` (stall-free admission), each pop is
        charged ``cost(req)`` prefill tokens and the FIFO head blocks
        further grants once it no longer fits; ``spent`` is prefill work
        already committed this step (an in-flight chunk).

        Head liveness: when nothing has been spent or granted yet this
        step, the head is granted even if its cost alone exceeds the
        budget, so no budget, however small, can stall the queue.

        With ``page_budget``/``page_cost`` (paged KV), each pop is also
        charged the fresh pages it seats. The page budget is strict, with
        no liveness overshoot: over-granting pages would make seating run
        out of pages mid-step. Pressure preemption frees pages instead,
        and the submit-time footprint check guarantees the head fits an
        otherwise empty pool."""
        if self.policy == "gang" and live_slots > 0:
            return []  # batch-synchronous: wait for the gang to drain
        granted: List[Request] = []
        remaining = None if token_budget is None else token_budget - spent
        pages_left = page_budget
        while self.queue and len(granted) < free_slots:
            head = self.queue[0]
            pc = page_cost(head) if pages_left is not None else 0
            if pages_left is not None and pc > pages_left:
                break
            if remaining is not None:
                c = cost(head)
                if c > remaining and (granted or spent > 0):
                    break
                remaining -= c
            if pages_left is not None:
                pages_left -= pc
            granted.append(self.queue.popleft())
        return granted
