"""Per-request SLO metrics (the port's copy of ``deepspeed_tpu/serving/
metrics.py``), emitted through an optional monitor.

Every finished request contributes its latencies (TTFT, queue wait,
per-token gap); :meth:`ServingMetrics.snapshot` reduces them to p50/p99
TTFT, req/s and tokens/s. With a monitor attached (any object with
``write_events([(tag, value, step), ...])``), each retirement also writes
``serving/*`` events on the engine's step axis. The Prometheus registry of
the JAX package arrives with the telemetry slice.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .request import FinishReason, RejectReason, Request


def _pct(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values), q)) if values else None


class ServingMetrics:
    """Accumulates finished/rejected requests; reduces to SLO aggregates."""

    def __init__(self, monitor: Optional[Any] = None,
                 step_fn: Optional[Any] = None):
        self.monitor = monitor
        self._step_fn = step_fn
        self.finished: List[Request] = []
        self.rejected: Dict[str, int] = {}
        self.failed: int = 0
        self.preempted: int = 0
        # decode-step aggregates (speculative decoding efficiency):
        # slot_steps counts (live slot, step) pairs, so tokens per decode
        # step is per slot: plain decode pins it at 1.0 and every accepted
        # draft pushes it above, whatever the batch occupancy
        self.decode_steps: int = 0
        self.decode_tokens: int = 0
        self.slot_steps: int = 0
        self.drafted: int = 0
        self.accepted_drafts: int = 0
        self.draft_time: float = 0.0
        self.step_time: float = 0.0
        self.prefill_tokens: int = 0
        self.prefill_dispatches: int = 0
        self.prefill_time: float = 0.0
        # prefill wall time while decode slots were live (the head-of-line
        # blocking that stall-free admission bounds)
        self.stall_time: float = 0.0
        # admission-time prefix-cache lookups (paged KV)
        self.prefix_lookups: int = 0
        self.prefix_hits: int = 0
        self.prefix_hit_tokens: int = 0
        self.prefix_lookup_tokens: int = 0
        # whole-step wall times of steps a RUNNING request waited through:
        # each is one user-visible inter-token gap, admissions included
        self.step_gaps: List[float] = []

    def _step(self) -> int:
        return int(self._step_fn()) if self._step_fn is not None \
            else self.decode_steps

    def _emit(self, events) -> None:
        if self.monitor is not None and getattr(self.monitor, "enabled",
                                                True):
            step = self._step()
            self.monitor.write_events([(tag, v, step) for tag, v in events])

    def record_rejection(self, req: Request) -> None:
        reason = RejectReason.of(req.reject_reason).value
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        self._emit([(f"serving/rejected/{reason}", 1.0)])

    def record_failure(self, req: Request) -> None:
        reason = FinishReason.of(req.finish_reason or FinishReason.ERROR)
        self.failed += 1
        self._emit([("serving/failed", 1.0),
                    (f"serving/failed/{reason.value}", 1.0)])

    def record_preemption(self, req: Request) -> None:
        """A seated request evicted back to the queue (its generated
        tokens ride along and are prefilled again on resume)."""
        self.preempted += 1
        self._emit([("serving/preempted", 1.0)])

    def record_prefix(self, hit_tokens: int, seed_len: int) -> None:
        """One admission-time prefix-cache lookup: ``hit_tokens`` of the
        ``seed_len``-token seed were served from cached pages (0 = miss)."""
        self.prefix_lookups += 1
        self.prefix_lookup_tokens += seed_len
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit_tokens
        self._emit([("serving/prefix_hit_tokens", float(hit_tokens))])

    def record_decode_step(self, emitted: int, live_slots: int,
                           drafted: int = 0, accepted: int = 0,
                           draft_s: float = 0.0, step_s: float = 0.0) -> None:
        """One decode (or draft + verify) step: ``emitted`` tokens across
        ``live_slots`` live slots; ``drafted``/``accepted`` count the draft
        proposals offered and accepted (0/0 with speculation off)."""
        self.decode_steps += 1
        self.decode_tokens += emitted
        self.slot_steps += live_slots
        self.drafted += drafted
        self.accepted_drafts += accepted
        self.draft_time += draft_s
        self.step_time += step_s
        if drafted:
            self._emit([("serving/spec_acceptance", accepted / drafted),
                        ("serving/spec_tokens_per_slot_step",
                         emitted / max(live_slots, 1))])

    def record_step_gap(self, seconds: float) -> None:
        self.step_gaps.append(seconds)

    def record_prefill(self, tokens: int, seconds: float,
                       blocking: bool) -> None:
        self.prefill_tokens += tokens
        self.prefill_dispatches += 1
        self.prefill_time += seconds
        if blocking:
            self.stall_time += seconds

    def record_finish(self, req: Request) -> None:
        reason = FinishReason.of(req.finish_reason).value  # closed enum
        self.finished.append(req)
        events = []
        if reason not in (FinishReason.EOS, FinishReason.LENGTH):
            events.append((f"serving/finished/{reason}", 1.0))
        events += [
            ("serving/ttft_ms", (req.ttft or 0.0) * 1e3),
            ("serving/queue_wait_ms", (req.queue_wait or 0.0) * 1e3),
            ("serving/per_token_ms", (req.per_token_latency or 0.0) * 1e3),
            ("serving/new_tokens", float(len(req.output_tokens))),
        ]
        self._emit(events)

    def snapshot(self) -> Dict[str, Any]:
        """Aggregate SLO view over everything finished so far;
        ``requests_per_s`` spans first submit -> last finish."""
        done = self.finished
        ttfts = [r.ttft for r in done if r.ttft is not None]
        waits = [r.queue_wait for r in done if r.queue_wait is not None]
        gaps = [r.per_token_latency for r in done
                if r.per_token_latency is not None]
        new_tokens = sum(len(r.output_tokens) for r in done)
        span = None
        if done:
            t0 = min(r.submit_time for r in done if r.submit_time is not None)
            t1 = max(r.finish_time for r in done if r.finish_time is not None)
            span = max(t1 - t0, 1e-9)
        return {
            "completed": len(done),
            "rejected": dict(self.rejected),
            "failed": self.failed,
            "preempted": self.preempted,
            "new_tokens": new_tokens,
            "decode_steps": self.decode_steps,
            "tokens_per_decode_step": (
                self.decode_tokens / self.slot_steps
                if self.slot_steps else None),
            "spec_drafted": self.drafted,
            "spec_accepted": self.accepted_drafts,
            "spec_acceptance_rate": (
                self.accepted_drafts / self.drafted
                if self.drafted else None),
            "draft_overhead_pct": (
                100.0 * self.draft_time / self.step_time
                if self.step_time > 0 else None),
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_lookups
                                if self.prefix_lookups else None),
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_token_hit_rate": (
                self.prefix_hit_tokens / self.prefix_lookup_tokens
                if self.prefix_lookup_tokens else None),
            "prefill_tokens": self.prefill_tokens,
            "prefill_dispatches": self.prefill_dispatches,
            "prefill_time_s": self.prefill_time,
            "stall_time_s": self.stall_time,
            "decode_time_s": self.step_time,
            "requests_per_s": (len(done) / span) if span else None,
            "tokens_per_s": (new_tokens / span) if span else None,
            "ttft_p50_ms": _pct([t * 1e3 for t in ttfts], 50),
            "ttft_p99_ms": _pct([t * 1e3 for t in ttfts], 99),
            "queue_wait_p50_ms": _pct([w * 1e3 for w in waits], 50),
            "per_token_p50_ms": _pct([g * 1e3 for g in gaps], 50),
            "per_token_p99_ms": _pct([g * 1e3 for g in gaps], 99),
            "step_gap_p50_ms": _pct([g * 1e3 for g in self.step_gaps], 50),
            "step_gap_p99_ms": _pct([g * 1e3 for g in self.step_gaps], 99),
        }
