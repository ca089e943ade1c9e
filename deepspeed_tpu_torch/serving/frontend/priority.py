"""Priority-class scheduling with fair-share token budgets and
per-tenant admission control (the port's copy of
``deepspeed_tpu/serving/frontend/priority.py``).

:class:`PriorityScheduler` extends the FIFO scheduler with three
production concerns the reference serving shells (DeepSpeed-MII / the
inference server entry points) handle in front of the engine:

* **Priority classes** — every :class:`~..request.Request` carries a
  ``priority_class``; :class:`PriorityConfig` orders the classes from
  highest to lowest rank. ``grant`` seats work in rank order (strict
  priority for slots) but splits the per-step prefill TOKEN budget into
  fair shares, so a flood of high-class prompts cannot monopolise every
  step's prefill budget and starve lower classes of admission entirely
  — each class with waiting work gets its share slice first, and
  whatever a class leaves unspent cascades to the others
  (work-conserving).
* **Per-tenant rate limits** — a token bucket per tenant (cost =
  ``prompt_len + max_new_tokens``, i.e. the worst-case tokens the
  request can consume) refilled on the injected monotonic ``clock``;
  an empty bucket rejects with :data:`RejectReason.RATE_LIMITED` and a
  refill-time ``retry_after_s`` hint.
* **Per-tenant queue quotas** — a bounded number of queued requests per
  tenant (:data:`RejectReason.TENANT_QUOTA`), so one tenant cannot fill
  the shared admission queue.

The scheduler stays host-only and device-free, and it deliberately
keeps the base class's SINGLE arrival-ordered deque: ``requeue_front``
/ ``requeue_back`` / ``expire`` / ``check_invariants`` all keep working
unchanged, and ``grant``/``head`` impose priority order by scanning (the
queue is bounded by ``max_queue_depth``, so the scan is O(depth) with a
small constant — not a hot path).

Liveness: the FIFO head-liveness guarantee (see
:meth:`FIFOScheduler.grant`) is preserved for the HIGHEST-RANKED waiter:
when nothing has been granted or spent this step, it is granted even if
its cost exceeds its fair share (bounded overshoot). Because rank order
is total, the lowest class becomes the highest-ranked waiter whenever
the classes above it are idle — so it still makes progress; no
starvation livelock (regression-pinned).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..request import RejectReason, Request
from ..scheduler import FIFOScheduler

DEFAULT_CLASSES = ("interactive", "standard", "batch")


@dataclasses.dataclass
class TenantPolicy:
    """Admission policy for one tenant (or the ``"*"`` wildcard).

    ``tokens_per_s`` is the token-bucket refill rate; cost per request
    is its worst-case token footprint (``prompt_len + max_new_tokens``).
    ``burst_tokens`` is the bucket capacity (defaults to 4x the rate —
    one second of burst headroom times four). ``max_queued`` bounds the
    tenant's simultaneously queued requests.
    """

    tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None
    max_queued: Optional[int] = None

    def __post_init__(self):
        if self.tokens_per_s is not None and self.tokens_per_s <= 0:
            raise ValueError("tokens_per_s must be positive")
        if self.burst_tokens is None and self.tokens_per_s is not None:
            self.burst_tokens = 4.0 * self.tokens_per_s

    @classmethod
    def resolve(cls, value) -> "TenantPolicy":
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"TenantPolicy expects dict or TenantPolicy, "
                        f"got {type(value).__name__}")


@dataclasses.dataclass
class PriorityConfig:
    """Class ranking, fair shares and tenant policies.

    ``classes`` orders priority classes from HIGHEST to LOWEST rank
    (rank 0 preempts/sheds last). ``shares`` weights the fair-share
    split of the per-step prefill token budget among classes that have
    waiting work (missing classes weigh 1.0). ``default_class`` is
    stamped on requests submitted without one (defaults to the LOWEST
    class — unclassified traffic must not outrank paying tiers).
    ``tenants`` maps tenant id -> :class:`TenantPolicy`; the ``"*"``
    entry, when present, applies to tenants without their own policy.
    """

    classes: Tuple[str, ...] = DEFAULT_CLASSES
    shares: Dict[str, float] = dataclasses.field(default_factory=dict)
    default_class: Optional[str] = None
    tenants: Dict[str, TenantPolicy] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.classes = tuple(self.classes)
        if not self.classes:
            raise ValueError("PriorityConfig needs at least one class")
        if len(set(self.classes)) != len(self.classes):
            raise ValueError(f"duplicate priority classes: {self.classes}")
        for cls_name, w in self.shares.items():
            if cls_name not in self.classes:
                raise ValueError(f"share for unknown class {cls_name!r}")
            if w <= 0:
                raise ValueError(f"share for {cls_name!r} must be positive")
        if self.default_class is None:
            self.default_class = self.classes[-1]
        elif self.default_class not in self.classes:
            raise ValueError(f"default_class {self.default_class!r} not in "
                             f"classes {self.classes}")
        self.tenants = {t: TenantPolicy.resolve(p)
                        for t, p in self.tenants.items()}

    def share(self, cls_name: str) -> float:
        return float(self.shares.get(cls_name, 1.0))

    @classmethod
    def resolve(cls, value) -> "PriorityConfig":
        """Coerce the ``priority=`` knob: ``True`` -> defaults, a dict
        -> field overrides, an instance -> itself."""
        if isinstance(value, cls):
            return value
        if value is True:
            return cls()
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"priority expects True, dict or PriorityConfig, "
                        f"got {type(value).__name__}")


class _TokenBucket:
    """Classic token bucket on an injected monotonic clock."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self.last = now

    def take(self, n: float, now: float) -> Optional[float]:
        """Charge ``n`` tokens. Returns None on success, else the
        seconds until the bucket will hold ``n`` (the retry hint)."""
        self.tokens = min(self.burst, self.tokens
                          + max(0.0, now - self.last) * self.rate)
        self.last = now
        if n <= self.tokens:
            self.tokens -= n
            return None
        return (n - self.tokens) / self.rate

    def refund(self, n: float) -> None:
        self.tokens = min(self.burst, self.tokens + n)


class PriorityScheduler(FIFOScheduler):
    """FIFO scheduler + priority classes, fair shares, tenant limits.

    Storage is the inherited single arrival-ordered deque; priority is
    imposed at ``grant``/``head`` time, so every base-class path that
    walks ``self.queue`` (requeue, expiry, invariant audits) works
    unmodified.
    """

    def __init__(self, num_slots: int, max_queue_depth: int = 64,
                 policy: str = "continuous", capacity: Optional[int] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, page_headroom: int = 0,
                 priority=True,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(num_slots, max_queue_depth=max_queue_depth,
                         policy=policy, capacity=capacity,
                         page_size=page_size, num_pages=num_pages,
                         page_headroom=page_headroom)
        self.config = PriorityConfig.resolve(priority)
        self._rank = {name: i for i, name in enumerate(self.config.classes)}
        # the ONE clock for every time-dependent decision in admission
        # (rate-bucket refill); the engine injects its own so deadlines,
        # expiry and rate limits can never drift apart (and tests can
        # drive a fake clock through all of them at once)
        self.clock = clock if clock is not None else time.monotonic
        self._buckets: Dict[str, _TokenBucket] = {}

    # -- class/tenant lookups ------------------------------------------
    def rank_of(self, cls_name: str) -> int:
        """0 = highest priority. Unknown classes fail loudly."""
        try:
            return self._rank[cls_name]
        except KeyError:
            raise ValueError(
                f"unknown priority class {cls_name!r}; configured classes: "
                f"{self.config.classes}") from None

    def class_of_rank(self, rank: int) -> str:
        return self.config.classes[rank]

    def _policy_for(self, tenant: str) -> Optional[TenantPolicy]:
        pol = self.config.tenants.get(tenant)
        if pol is None:
            pol = self.config.tenants.get("*")
        return pol

    def class_depths(self) -> Dict[str, int]:
        """Queued-request count per class (telemetry/healthz)."""
        depths = {c: 0 for c in self.config.classes}
        for r in self.queue:
            depths[r.priority_class] = depths.get(r.priority_class, 0) + 1
        return depths

    # -- admission ------------------------------------------------------
    def submit(self, req: Request) -> Tuple[bool, Optional[RejectReason]]:
        """Tenant quota -> tenant rate limit -> base admission control.

        Quota is checked before the rate bucket so a quota rejection
        never burns bucket tokens; a base-admission rejection (queue
        full / prompt too long) REFUNDS the bucket — only requests that
        actually join the queue consume rate."""
        if req.priority_class == "default" \
                and "default" not in self._rank:
            # a bare Request carries the dataclass default; stamp the
            # configured default class so rank lookups are total
            req.priority_class = self.config.default_class
        self.rank_of(req.priority_class)  # fail loudly on unknown class
        pol = self._policy_for(req.tenant)
        charged = 0.0
        if pol is not None:
            if pol.max_queued is not None:
                queued = sum(1 for r in self.queue if r.tenant == req.tenant)
                if queued >= pol.max_queued:
                    return False, RejectReason.TENANT_QUOTA
            if pol.tokens_per_s is not None:
                now = self.clock()
                bucket = self._buckets.get(req.tenant)
                if bucket is None:
                    bucket = _TokenBucket(pol.tokens_per_s,
                                          pol.burst_tokens, now)
                    self._buckets[req.tenant] = bucket
                need = float(req.prompt_len + req.max_new_tokens)
                hint = bucket.take(need, now)
                if hint is not None:
                    req.retry_after_s = hint
                    return False, RejectReason.RATE_LIMITED
                charged = need
        ok, reason = super().submit(req)
        if not ok and charged:
            self._buckets[req.tenant].refund(charged)
        return ok, reason

    # -- priority-ordered grant ----------------------------------------
    def head(self) -> Optional[Request]:
        """The request ``grant`` would pop first: oldest waiter of the
        highest-priority class with queued work."""
        best = None
        best_rank = len(self.config.classes)
        for r in self.queue:
            k = self.rank_of(r.priority_class)
            if k < best_rank:
                best, best_rank = r, k
                if k == 0:
                    break
        return best

    def head_within(self, max_rank: int) -> Optional[Request]:
        """Oldest waiter whose class rank is <= ``max_rank`` (i.e. at
        least that priority), or None — the burn-rate preemption path
        asks this to decide whether a protected-class request is stuck
        behind shed-class residents."""
        best = None
        best_rank = max_rank + 1
        for r in self.queue:
            k = self.rank_of(r.priority_class)
            if k < best_rank:
                best, best_rank = r, k
                if k == 0:
                    break
        return best

    def grant(self, free_slots: int, live_slots: int,
              token_budget: Optional[int] = None,
              cost=None, spent: int = 0,
              page_budget: Optional[int] = None,
              page_cost=None) -> List[Request]:
        """Priority grant: strict rank order for SLOTS, fair-share split
        of the prefill TOKEN budget.

        Pass 1 walks classes from highest rank down, granting each class
        FIFO-within-class against its fair-share slice of the remaining
        token budget (``shares`` weights, classes with no waiters
        excluded). Pass 2 is work-conserving: leftover budget (slices a
        class could not spend) is re-offered in rank order. The page
        budget stays STRICT and GLOBAL exactly as in the base class —
        the first head that does not fit the page budget stops the whole
        grant, because letting lower classes consume pages the blocked
        head needs would invert priority under memory pressure (pressure
        preemption, not over-grant, is what frees pages).

        Liveness: the highest-ranked waiter inherits the base class's
        head-liveness overshoot — when nothing was granted or spent yet,
        it is granted even over budget. With higher classes idle the
        lowest class IS the highest-ranked waiter, so every class
        eventually progresses (no starvation livelock; pinned).
        """
        if self.policy == "gang" and live_slots > 0:
            return []
        if not self.queue or free_slots <= 0:
            return []
        by_rank: Dict[int, List[Request]] = {}
        for r in self.queue:
            by_rank.setdefault(self.rank_of(r.priority_class), []).append(r)
        ranks = sorted(by_rank)

        budgeted = token_budget is not None
        remaining = (token_budget - spent) if budgeted else 0
        slices: Dict[int, float] = {}
        if budgeted:
            total_share = sum(self.config.share(self.class_of_rank(k))
                              for k in ranks)
            for k in ranks:
                slices[k] = (max(0, remaining)
                             * self.config.share(self.class_of_rank(k))
                             / total_share)

        granted: List[Request] = []
        granted_ids = set()
        pages_left = page_budget
        page_blocked = False

        def fits_pages(req: Request) -> Tuple[bool, int]:
            if pages_left is None:
                return True, 0
            pc = page_cost(req) if page_cost is not None else 0
            return pc <= pages_left, pc

        # pass 1: per-class fair-share slices, rank order
        for k in ranks:
            if len(granted) >= free_slots or page_blocked:
                break
            for req in by_rank[k]:
                if len(granted) >= free_slots:
                    break
                ok_pages, pc = fits_pages(req)
                if not ok_pages:
                    page_blocked = True  # strict + global: stop everything
                    break
                c = (cost(req) if cost is not None else 0) if budgeted else 0
                if budgeted and c > min(slices[k], remaining):
                    # (min with the global remainder: a higher class's
                    # liveness overshoot must not be spent twice)
                    # head-liveness overshoot: the very first grantable
                    # waiter (== self.head()) goes through regardless
                    if granted or spent > 0:
                        break  # this class's slice is spent; next class
                if budgeted:
                    slices[k] -= c
                    remaining -= c
                if pages_left is not None:
                    pages_left -= pc
                granted.append(req)
                granted_ids.add(id(req))

        # pass 2: work-conserving leftover, rank order, global remainder
        if budgeted and not page_blocked and remaining > 0:
            for k in ranks:
                if len(granted) >= free_slots:
                    break
                for req in by_rank[k]:
                    if id(req) in granted_ids:
                        continue
                    if len(granted) >= free_slots:
                        break
                    ok_pages, pc = fits_pages(req)
                    if not ok_pages:
                        page_blocked = True
                        break
                    c = cost(req) if cost is not None else 0
                    if c > remaining:
                        break  # FIFO-within-class: don't skip past a head
                    remaining -= c
                    if pages_left is not None:
                        pages_left -= pc
                    granted.append(req)
                    granted_ids.add(id(req))
                if page_blocked:
                    break

        if granted:
            self.queue = type(self.queue)(
                r for r in self.queue if id(r) not in granted_ids)
        return granted
