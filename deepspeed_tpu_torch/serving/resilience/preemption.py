"""Victim selection for slot preemption (the port's copy of
``deepspeed_tpu/serving/resilience/preemption.py``, without priority
classes).

When the paged pool runs out of pages, the engine evicts a seated request
to free its pages. The policy is youngest / lowest-progress first: the
request with the fewest generated tokens wastes the least work (its whole
history is prefilled again on resume), and among equals the most recently
admitted goes first. Requests admitted fewer than ``min_run_steps`` steps
ago are not eligible.
"""

from __future__ import annotations

from typing import Iterable, List

from ..request import Request, RequestState

#: states that hold a slot (QUEUED has none; terminal states free theirs)
PREEMPTABLE_STATES = (RequestState.RUNNING, RequestState.PREFILLING)


def select_victims(candidates: Iterable[Request], n: int = 1,
                   current_step: int = 0,
                   min_run_steps: int = 2) -> List[Request]:
    """Up to ``n`` eligible victims, youngest / lowest-progress first, in
    a total, deterministic order (fewest generated tokens, then latest
    admission, then newest request id)."""
    eligible = [r for r in candidates
                if r.state in PREEMPTABLE_STATES
                and current_step - r.last_admit_step >= min_run_steps]
    eligible.sort(key=lambda r: (len(r.output_tokens), -r.last_admit_step,
                                 -r.request_id))
    return eligible[:max(n, 0)]
