"""Request model for the serving subsystem (the port's copy of
``deepspeed_tpu/serving/request.py``, cut to what this slice serves).

A :class:`Request` moves through ``QUEUED -> [PREFILLING ->] RUNNING ->
FINISHED`` (or ``REJECTED`` straight out of admission control, or
``FAILED`` when a step raised while it was seated). ``PREFILLING`` is the
stall-free stage in which a long prompt streams into its slot chunk by
chunk; page-pressure preemption sends a seated request back to ``QUEUED``
with its generated tokens, which its next admission prefills again
(:attr:`Request.seed_tokens`). The object doubles as the per-request SLO
record: the engine stamps times at each transition and the latencies are
derived properties. Terminal reasons are closed ``str`` enums, so
``req.finish_reason == "eos"`` works. The JAX package's deadline and
multi-tenant fields arrive with those slices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Union

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"  # seated, prompt streaming in by chunks
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"
    FAILED = "failed"       # aborted by a mid-step engine exception


class FinishReason(str, enum.Enum):
    """Why a request left via FINISHED (or FAILED)."""

    EOS = "eos"                  # emitted its eos_token_id
    LENGTH = "length"            # hit max_new_tokens
    LENGTH_CAP = "length_cap"    # cache row full (capacity)
    ERROR = "error"              # mid-step engine exception

    __str__ = str.__str__

    @classmethod
    def of(cls, value: Union[str, "FinishReason"]) -> "FinishReason":
        """Validate/coerce; raises ``ValueError`` on unknown reasons."""
        return cls(value)


class RejectReason(str, enum.Enum):
    """Why admission control refused a submission."""

    QUEUE_FULL = "queue_full"            # bounded queue at depth
    PROMPT_TOO_LONG = "prompt_too_long"  # can never fit the KV capacity

    __str__ = str.__str__

    @classmethod
    def of(cls, value: Union[str, "RejectReason"]) -> "RejectReason":
        return cls(value)


@dataclasses.dataclass(eq=False)  # identity semantics: numpy prompts
class Request:
    """One generation request plus its lifecycle/metric record.

    ``output_tokens`` holds every sampled token, the EOS token included, as
    ``InferenceEngine.generate`` returns it. Times are ``perf_counter``
    stamps, ``None`` until the transition happens.
    """

    request_id: int
    prompt: np.ndarray                      # (T,) int32
    max_new_tokens: int
    eos_token_id: Optional[int] = None

    state: RequestState = RequestState.QUEUED
    reject_reason: Optional[RejectReason] = None
    finish_reason: Optional[FinishReason] = None
    slot: Optional[int] = None
    prefill_pos: int = 0                    # seed tokens already written
    #                                         into the slot (chunked prefill)
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    preemptions: int = 0                    # times bounced back to QUEUED
    last_admit_step: int = -1               # engine step_id of last seating
    prefix_hit_tokens: int = 0              # seed tokens skipped at seating
    #                                         through the prefix cache
    chunks: int = 0                         # chunked-prefill dispatches run
    spec_drafted: int = 0                   # draft tokens proposed for this
    #                                         request's slot
    spec_accepted: int = 0                  # draft tokens accepted

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

    @property
    def seed_tokens(self) -> np.ndarray:
        """What admission prefills into a slot: the prompt, plus, after a
        preemption, everything generated so far. The last generated token
        has not been fed through the model yet, so prefilling the whole
        history and sampling at its last position gives exactly the token
        the next decode step would have: greedy output is unchanged by a
        preemption."""
        return self.tokens() if self.output_tokens else \
            np.asarray(self.prompt, np.int32)

    @property
    def seed_len(self) -> int:
        """Tokens admission prefills: the prompt plus those generated."""
        return self.prompt_len + len(self.output_tokens)

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
        """Mean gap per token after the first."""
        if self.first_token_time is None or self.finish_time is None:
            return None
        n = len(self.output_tokens)
        if n <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (n - 1)
