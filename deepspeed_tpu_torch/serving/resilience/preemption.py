"""Victim selection for slot preemption (the port's copy of
``deepspeed_tpu/serving/resilience/preemption.py``).

When the engine must free a slot (queue pressure past the configured
threshold, or an operator calling ``preempt()``), the victim policy
decides WHO loses their seat. The policy is youngest / lowest-progress
first: preempting the request with the fewest generated tokens wastes
the least completed work (its whole history is re-prefilled on resume,
so sunk cost is proportional to progress), and among equals the most
recently admitted goes first (it has waited the least and its
re-queue-at-the-front costs the least extra latency).

Requests admitted fewer than ``min_run_steps`` steps ago are
ineligible — a freshly seated request must make SOME progress before
it can be bounced again, or pressure-preemption degenerates into
admission thrash that generates zero tokens.
"""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional

from ..request import Request, RequestState

#: preemptable lifecycle states (QUEUED has no slot; terminal states
#: have nothing left to free)
PREEMPTABLE_STATES = (RequestState.RUNNING, RequestState.PREFILLING)


def select_victims(candidates: Iterable[Request], n: int = 1,
                   current_step: int = 0,
                   min_run_steps: int = 2,
                   class_rank: Optional[Callable[[Request], int]] = None,
                   ) -> List[Request]:
    """Rank preemption candidates youngest/lowest-progress first and
    return up to ``n`` eligible victims.

    ``candidates`` are seated requests (RUNNING or PREFILLING);
    anything else is skipped. Eligibility additionally requires the
    request to have held its slot for at least ``min_run_steps``
    scheduler steps (``current_step - last_admit_step``).

    With ``class_rank`` (priority scheduling; maps a request to its
    class rank, 0 = highest priority), the LOWEST class is victimized
    first — rank dominates the sunk-work tiebreak, so an interactive
    request is never bounced while a batch request holds a slot."""
    eligible = [
        r for r in candidates
        if r.state in PREEMPTABLE_STATES
        and (current_step - r.last_admit_step) >= min_run_steps]
    # lowest priority class first (when ranked), then fewest generated
    # tokens (least sunk work), then most recent admission, then newest
    # request id — a total, deterministic order
    rank = class_rank if class_rank is not None else (lambda r: 0)
    eligible.sort(key=lambda r: (-rank(r), len(r.output_tokens),
                                 -r.last_admit_step, -r.request_id))
    return eligible[:max(n, 0)]
