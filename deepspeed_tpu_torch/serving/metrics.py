"""Per-request SLO metrics, aggregated and emitted through the monitor
(the port's copy of ``deepspeed_tpu/serving/metrics.py``).

Every finished request contributes its derived latencies (TTFT, queue
wait, per-token gap) to the aggregate; :meth:`ServingMetrics.snapshot`
reduces them to the serving-SLO quantiles (p50/p99 TTFT, req/s,
tokens/s) the benchmark row and dashboards report. When a
monitor (any object with ``write_events``) is attached, each
retirement writes ``serving/*`` events — the same ``(tag, value,
step)`` event path training metrics use, so the existing
TensorBoard/W&B/CSV/JSONL sinks pick serving traffic up with zero new
plumbing.

Every monitor event carries ONE step axis: the serving engine's
monotonic step counter (``step_fn``), so rejection, finish, and
speculative-efficiency series line up across sinks. (They used to mix
request ids and decode-step counts — useless for correlating a
rejection burst with the decode stall that caused it.) Standalone
instances without a ``step_fn`` fall back to ``decode_steps``.

When a :class:`~deepspeed_tpu_torch.telemetry.MetricsRegistry` is attached,
the same observations also land in Prometheus-exportable
counters/histograms (``serving/*``).
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
                 registry: Optional[Any] = None,
                 step_fn: Optional[Any] = None):
        self.monitor = monitor
        self.registry = registry
        self._step_fn = step_fn
        self.finished: List[Request] = []
        self.rejected: Dict[str, int] = {}
        self.failed: int = 0
        self.failed_reasons: Dict[str, int] = {}
        self.preempted: int = 0
        self.step_overruns: int = 0
        self.load_transitions: int = 0
        # decode-step aggregates (speculative decoding efficiency):
        # slot_steps counts (live slot, step) pairs so tokens/decode-step
        # is per-slot — plain decode pins it at exactly 1.0 and any
        # accepted draft pushes it above, regardless of batch occupancy
        self.decode_steps: int = 0
        self.decode_tokens: int = 0
        self.slot_steps: int = 0
        self.drafted: int = 0
        self.accepted_drafts: int = 0
        self.draft_time: float = 0.0
        self.step_time: float = 0.0
        # prefill/decode split (stall-free admission): stall_time is the
        # subset of prefill wall-time that ran while decode slots were
        # live — the head-of-line blocking the chunked/budgeted admission
        # policy exists to bound
        self.prefill_tokens: int = 0
        self.prefill_dispatches: int = 0
        self.prefill_time: float = 0.0
        self.stall_time: float = 0.0
        # paged-KV prefix cache (admission-time trie lookups): hit
        # tokens are seed tokens whose prefill was SKIPPED by mapping
        # cached pages — the TTFT lever the paging bench row measures
        self.prefix_lookups: int = 0
        self.prefix_hits: int = 0
        self.prefix_hit_tokens: int = 0
        self.prefix_lookup_tokens: int = 0
        # whole-step wall times for steps where a RUNNING request was
        # waiting at step start: each is one user-visible inter-token
        # gap, admissions included. The per-request mean (per_token_*)
        # amortizes a monolithic prefill stall away; the p99 of THESE is
        # the jitter/SLO tail stall-free admission exists to bound
        self.step_gaps: List[float] = []

    # ------------------------------------------------------------------
    def _step(self) -> int:
        """The shared step axis for every monitor event (see module doc)."""
        return int(self._step_fn()) if self._step_fn is not None \
            else self.decode_steps

    def _inc(self, name: str, amount: float = 1.0) -> None:
        if self.registry is not None:
            self.registry.counter(name).inc(amount)

    def _observe_ms(self, name: str, seconds: float) -> None:
        if self.registry is not None:
            self.registry.histogram(name).observe(seconds * 1e3)

    def record_rejection(self, req: Request) -> None:
        # validate against the closed enum BEFORE emitting: a typo'd
        # reason must fail here, not silently fork a new metrics series
        reason = RejectReason.of(req.reject_reason).value
        self.rejected[reason] = self.rejected.get(reason, 0) + 1
        self._inc(f"serving/rejected/{reason}")
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            self.monitor.write_events([
                (f"serving/rejected/{reason}", 1.0, self._step())])

    def record_failure(self, req: Request) -> None:
        """A running request killed mid-flight: a step-wide engine
        exception (``error``) or a per-slot NaN/inf logits detection
        (``numerical_error``)."""
        reason = FinishReason.of(req.finish_reason or FinishReason.ERROR).value
        self.failed += 1
        self.failed_reasons[reason] = self.failed_reasons.get(reason, 0) + 1
        self._inc("serving/failed")
        self._inc(f"serving/failed/{reason}")
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            step = self._step()
            self.monitor.write_events([
                ("serving/failed", 1.0, step),
                (f"serving/failed/{reason}", 1.0, step)])

    def record_preemption(self, req: Request) -> None:
        """A seated request evicted back to the queue (slot reclaimed;
        its generated tokens ride along and are re-prefilled on
        resume)."""
        self.preempted += 1
        self._inc("serving/preempted")
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            self.monitor.write_events([
                ("serving/preempted", 1.0, self._step())])

    def record_step_overrun(self, seconds: float, budget_ms: float) -> None:
        """One scheduler step blew through the per-step wall-time budget
        (the step watchdog fired)."""
        self.step_overruns += 1
        self._inc("serving/step_overruns")
        self._observe_ms("serving/step_overrun_ms", seconds)
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            self.monitor.write_events([
                ("serving/step_overrun_ms", seconds * 1e3, self._step())])

    def record_load_state(self, old: Any, new: Any) -> None:
        """A graceful-degradation transition; the event value is the NEW
        level's int encoding so dashboards plot the ladder directly."""
        self.load_transitions += 1
        self._inc("serving/load_transitions")
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            self.monitor.write_events([
                ("serving/load_state", float(int(new)), self._step())])

    def record_decode_step(self, emitted: int, live_slots: int,
                           drafted: int = 0, accepted: int = 0,
                           draft_s: float = 0.0, step_s: float = 0.0) -> None:
        """One decode (or draft+verify) step: ``emitted`` tokens across
        ``live_slots`` live slots; ``drafted``/``accepted`` count draft
        proposals offered/accepted (0/0 when speculation is off)."""
        self.decode_steps += 1
        self.decode_tokens += emitted
        self.slot_steps += live_slots
        self.drafted += drafted
        self.accepted_drafts += accepted
        self.draft_time += draft_s
        self.step_time += step_s
        self._inc("serving/decode_tokens", emitted)
        if drafted and self.monitor is not None and \
                getattr(self.monitor, "enabled", True):
            step = self._step()
            self.monitor.write_events([
                ("serving/spec_acceptance", accepted / drafted, step),
                ("serving/spec_tokens_per_slot_step",
                 emitted / max(live_slots, 1), step),
            ])

    def record_step_gap(self, seconds: float) -> None:
        """One full scheduler step during which at least one RUNNING
        request was waiting on its next token (see ``step_gaps``)."""
        self.step_gaps.append(seconds)
        self._observe_ms("serving/step_gap_ms", seconds)

    def record_prefill(self, tokens: int, seconds: float,
                       blocking: bool) -> None:
        """One prefill dispatch (bucketed admission batch or one chunk):
        ``tokens`` of prompt processed in ``seconds``; ``blocking`` means
        live decode slots were waiting on it (stall time)."""
        self.prefill_tokens += tokens
        self.prefill_dispatches += 1
        self.prefill_time += seconds
        self._inc("serving/prefill_tokens", tokens)
        if blocking:
            self.stall_time += seconds

    def record_prefix(self, hit_tokens: int, seed_len: int) -> None:
        """One admission-time prefix-cache lookup: ``hit_tokens`` of the
        ``seed_len``-token seed were served from cached pages (0 = miss).
        Mirrored into the registry as ``paging/*`` counters so the
        Prometheus export carries the hit ratio."""
        self.prefix_lookups += 1
        self.prefix_lookup_tokens += seed_len
        if hit_tokens > 0:
            self.prefix_hits += 1
            self.prefix_hit_tokens += hit_tokens
            self._inc("paging/prefix_hits")
            self._inc("paging/prefix_hit_tokens", hit_tokens)
        else:
            self._inc("paging/prefix_misses")
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            self.monitor.write_events([
                ("serving/prefix_hit_tokens", float(hit_tokens),
                 self._step())])

    def record_finish(self, req: Request) -> None:
        reason = FinishReason.of(req.finish_reason).value  # closed enum
        self.finished.append(req)
        self._inc("serving/finished")
        if req.ttft is not None:
            self._observe_ms("serving/ttft_ms", req.ttft)
        if req.queue_wait is not None:
            self._observe_ms("serving/queue_wait_ms", req.queue_wait)
        if req.per_token_latency is not None:
            self._observe_ms("serving/per_token_ms", req.per_token_latency)
        if self.monitor is not None and getattr(self.monitor, "enabled", True):
            step = self._step()
            if reason not in (FinishReason.EOS, FinishReason.LENGTH):
                # the abnormal retirements (length_cap: capacity sizing;
                # deadline: SLO misses) are ops-worthy — each gets its
                # own per-reason event series
                self.monitor.write_events([
                    (f"serving/finished/{reason}", 1.0, step)])
            self.monitor.write_events([
                ("serving/ttft_ms", (req.ttft or 0.0) * 1e3, step),
                ("serving/queue_wait_ms", (req.queue_wait or 0.0) * 1e3,
                 step),
                ("serving/per_token_ms", (req.per_token_latency or 0.0) * 1e3,
                 step),
                ("serving/new_tokens", float(len(req.output_tokens)),
                 step),
            ])

    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Aggregate SLO view over everything finished so far.

        ``requests_per_s`` spans first submit -> last finish: it charges
        the server for queueing delay, which is the number a capacity
        planner actually needs (completions per wall-second under the
        offered load), not a best-case decode rate.
        """
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
            "failed_reasons": dict(self.failed_reasons),
            "preempted": self.preempted,
            "deadline_expired": sum(
                1 for r in done if r.finish_reason == FinishReason.DEADLINE),
            "cancelled": sum(
                1 for r in done if r.finish_reason == FinishReason.CANCELLED),
            "step_overruns": self.step_overruns,
            "load_transitions": self.load_transitions,
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
            "prefix_hit_rate": (
                self.prefix_hits / self.prefix_lookups
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
