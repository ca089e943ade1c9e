"""Request model for the serving subsystem (the port's copy of
``deepspeed_tpu/serving/request.py``, the fleet trace context included:
``journey_id`` and ``hop``, which :class:`~.router.ReplicaRouter` stamps).

A :class:`Request` is one user generation job moving through the
lifecycle ``QUEUED -> [PREFILLING ->] RUNNING -> FINISHED`` (or
``REJECTED`` straight out of admission control; ``PREFILLING`` is the
stall-free chunked-admission stage for prompts longer than the serving
engine's chunk width; preemption sends a seated request back to
``QUEUED`` carrying its generated-so-far tokens). The object doubles as
the per-request SLO record: the scheduler stamps wall-clock times at
each transition and the latency metrics (TTFT, queue wait, per-token
latency) are derived properties, so there is exactly one place timing
truth lives.

Terminal reasons are CLOSED ENUMS (:class:`FinishReason`,
:class:`RejectReason`), not free-form strings: every monitor event,
stats key and timeline attribute derives from them, and
:class:`~deepspeed_tpu_torch.serving.metrics.ServingMetrics` validates each
recorded reason against the enum so a typo'd reason fails loudly at the
emit site instead of silently forking a new metrics series. Both enums
are ``str`` subclasses, so ``req.finish_reason == "eos"`` keeps
working everywhere.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Union

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"  # seated in a slot, prompt streaming in by
    #                            bounded chunks (stall-free admission)
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"
    FAILED = "failed"       # aborted by a mid-step engine exception


class FinishReason(str, enum.Enum):
    """Why a request left via FINISHED (or FAILED — the error reasons).

    ``str`` mixin: members compare and format as their values, so
    existing ``finish_reason == "eos"`` comparisons and f-string tags
    are unchanged.
    """

    EOS = "eos"                          # emitted its eos_token_id
    LENGTH = "length"                    # hit max_new_tokens
    LENGTH_CAP = "length_cap"            # cache row full (capacity)
    DEADLINE = "deadline"                # per-request deadline expired
    CANCELLED = "cancelled"              # client cancelled / disconnected
    ERROR = "error"                      # mid-step engine exception
    NUMERICAL_ERROR = "numerical_error"  # NaN/inf logits in this slot

    __str__ = str.__str__  # "eos", not "FinishReason.EOS" (py<3.11 quirk)

    @classmethod
    def of(cls, value: Union[str, "FinishReason"]) -> "FinishReason":
        """Validate/coerce; raises ``ValueError`` on unknown reasons."""
        return cls(value)


class RejectReason(str, enum.Enum):
    """Why admission control refused a submission."""

    QUEUE_FULL = "queue_full"            # bounded queue at depth
    PROMPT_TOO_LONG = "prompt_too_long"  # can never fit the KV capacity
    RETRY_AFTER = "retry_after"          # shed by overload degradation or
    #                                      burn-rate class shedding;
    #                                      retry_after_s carries the hint
    RATE_LIMITED = "rate_limited"        # tenant token bucket empty
    TENANT_QUOTA = "tenant_quota"        # tenant queue quota reached

    __str__ = str.__str__

    @classmethod
    def of(cls, value: Union[str, "RejectReason"]) -> "RejectReason":
        return cls(value)


@dataclasses.dataclass(eq=False)  # identity semantics: a generated __eq__
#                                   would elementwise-compare numpy prompts
#                                   (ambiguous truth) and drop hashability
class Request:
    """One generation request plus its lifecycle/metric record.

    ``output_tokens`` includes every sampled token (the EOS token too,
    matching ``InferenceEngine.generate`` which returns the row through
    its first EOS). Timing fields are ``time.perf_counter`` stamps set
    by the serving engine; they are ``None`` until the corresponding
    transition happens.
    """

    request_id: int
    prompt: np.ndarray                      # (T,) int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None

    # -- multi-tenancy --------------------------------------------------
    priority_class: str = "default"         # scheduling class; rank order
    #                                         comes from PriorityConfig
    tenant: str = "default"                 # rate-limit / quota bucket

    state: RequestState = RequestState.QUEUED
    reject_reason: Optional[RejectReason] = None
    finish_reason: Optional[FinishReason] = None
    slot: Optional[int] = None
    prefill_pos: int = 0                    # seed tokens already written
    #                                         into the slot (chunked prefill)
    output_tokens: List[int] = dataclasses.field(default_factory=list)

    # -- resilience -----------------------------------------------------
    deadline_ms: Optional[float] = None     # TTL from submit; None = none
    deadline_time: Optional[float] = None   # absolute perf_counter stamp
    retry_after_s: Optional[float] = None   # backoff hint on RETRY_AFTER
    preemptions: int = 0                    # times bounced back to QUEUED
    last_admit_step: int = -1               # engine step_id of last seating

    # telemetry counters (per-request lifecycle accounting)
    prefix_hit_tokens: int = 0              # seed tokens skipped at seating
    #                                         via the paged prefix cache
    chunks: int = 0                         # chunked-prefill dispatches run
    spec_drafted: int = 0                   # draft tokens proposed for this
    #                                         request's slot
    spec_accepted: int = 0                  # draft tokens accepted

    # -- fleet trace context --------------------------------------------
    # minted by ReplicaRouter.submit and carried across every replica
    # boundary (handoff, page transfer, failover), so each home's tracer
    # and timeline store stamp the same journey; None on a bare engine
    journey_id: Optional[int] = None
    hop: int = 0                            # replica-boundary crossings

    submit_time: Optional[float] = None
    admit_time: Optional[float] = None      # prefill issued (slot granted)
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(np.shape(self.prompt)[0])

    def tokens(self) -> np.ndarray:
        """Prompt + generated tokens, the ``generate()``-shaped row."""
        return np.concatenate(
            [np.asarray(self.prompt, np.int32),
             np.asarray(self.output_tokens, np.int32)])

    # -- preemption resume ---------------------------------------------
    @property
    def seed_tokens(self) -> np.ndarray:
        """What admission must prefill into a slot: the prompt, plus —
        after a preemption — everything generated so far. The last
        generated token has never been fed through the model (the
        decode loop feeds it next), so re-prefilling the FULL history
        and sampling at its last position produces exactly the token
        the next decode step would have: greedy output is bitwise
        identical across preemptions."""
        return self.tokens() if self.output_tokens else \
            np.asarray(self.prompt, np.int32)

    @property
    def seed_len(self) -> int:
        return self.prompt_len + len(self.output_tokens)

    def expired(self, now: float) -> bool:
        """Deadline passed? (False when no deadline is set.)"""
        return self.deadline_time is not None and now >= self.deadline_time

    # -- derived SLO metrics (seconds; None until the inputs exist) ----
    @property
    def queue_wait(self) -> Optional[float]:
        if self.submit_time is None or self.admit_time is None:
            return None
        return self.admit_time - self.submit_time

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token: submit -> first sampled token."""
        if self.submit_time is None or self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    @property
    def per_token_latency(self) -> Optional[float]:
        """Mean decode latency per token AFTER the first (the steady-state
        inter-token gap users see while a response streams)."""
        if self.first_token_time is None or self.finish_time is None:
            return None
        n = len(self.output_tokens)
        if n <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (n - 1)
