"""ServingEngine: request-level continuous batching over InferenceEngine
(port of ``deepspeed_tpu/serving/engine.py``, serial bucketed admission over
the contiguous slot pool).

Requests arrive one at a time via :meth:`submit`. Each :meth:`step` grants
free slots to queued requests, prefills each granted prompt straight into
its slot's cache row (right-padded to a power-of-two bucket of at least 16,
projecting the true last position), then runs ONE decode step for every
live slot at batch = ``num_slots`` with per-slot cache offsets; finished
sequences retire at once and their slot goes back to work (Orca-style
iteration-level scheduling). Sampled tokens stay on the device during the
step; one host fetch at the end of the step replays the bookkeeping in
dispatch order.

This slice serves ``prefill_chunk=0`` only: stall-free chunked admission
(the JAX default), paged KV, speculative decoding, the pipelined
``overlap`` step and the resilience/telemetry keys are later slices, and
passing any of them raises ``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist
from .metrics import ServingMetrics
from .request import FinishReason, Request, RequestState
from .resilience.errors import InvariantViolation, ServingStalledError
from .scheduler import FIFOScheduler
from .slot_pool import SlotPool

_MIN_PREFILL_BUCKET = 16

# serving keys of the JAX engine that this port does not have yet; None or
# False means "off" and is accepted, any other value raises
NOT_PORTED = ("prefill_token_budget", "spec_decode", "paged_kv", "overlap",
              "tracer", "registry", "strict_recompile", "timeline_capacity",
              "deadline_default_ms", "step_wall_budget_ms", "guard_numerics",
              "degradation", "preempt_queue_threshold",
              "preempt_min_run_steps", "fault_injector", "cost_model", "slo",
              "flight_recorder", "dump_dir", "priority", "clock", "role")


class ServingEngine:
    """Continuous-batching server over a built
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    Construct via :func:`deepspeed_tpu_torch.init_serving`. Sampling knobs
    are server-global and default to the inference config's (greedy unless
    ``do_sample``); ``max_new_tokens`` and ``eos_token_id`` ride on each
    request.
    """

    def __init__(self, engine: Any, num_slots: int = 4,
                 max_queue_depth: int = 64, policy: str = "continuous",
                 do_sample: bool = False,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0, monitor: Optional[Any] = None,
                 prefill_chunk: int = 0, **not_ported: Any):
        for key, val in not_ported.items():
            if key not in NOT_PORTED:
                raise TypeError(f"unexpected ServingEngine argument {key!r}")
            if val is not None and val is not False:
                raise NotImplementedError(
                    f"serving key {key!r} is not ported to the PyTorch/CUDA "
                    f"package yet")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        if prefill_chunk > 0:
            raise NotImplementedError(
                "prefill_chunk > 0 (stall-free chunked admission) is a later "
                "slice of the port; pass prefill_chunk=0")
        self.engine = engine
        self._now = time.perf_counter
        self.device = engine.device
        self.pool = SlotPool(engine.kv_cache_spec(), num_slots, self.device)
        self.scheduler = FIFOScheduler(num_slots, max_queue_depth, policy,
                                       capacity=self.pool.capacity)
        self.step_id = 0
        self.metrics = ServingMetrics(monitor, step_fn=lambda: self.step_id)
        cfg = engine._config
        self.temperature = cfg.temperature if temperature is None \
            else temperature
        self.top_k = cfg.top_k if top_k is None else top_k
        self.top_p = cfg.top_p if top_p is None else top_p
        self._greedy = not do_sample
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._slot_req: dict = {}                      # slot -> Request
        # last sampled token per slot, on the device: the decode step reads
        # it without waiting for the host
        self._cur = torch.zeros((num_slots,), dtype=torch.long,
                                device=self.device)
        # (device tensor, callback) pairs replayed after the step's fetch
        self._deferred: List[Tuple[torch.Tensor, Callable]] = []
        self._next_id = 0
        log_dist(f"ServingEngine: slots={num_slots} policy={policy} "
                 f"capacity={self.pool.capacity} "
                 f"max_queue_depth={max_queue_depth} admission=serial",
                 ranks=[0])

    # ------------------------------------------------------------------
    @property
    def live_count(self) -> int:
        return len(self._slot_req)

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> Request:
        """Enqueue one generation request. Never raises on load: admission
        control marks the returned request ``REJECTED`` with a
        ``reject_reason`` (``"queue_full"``, ``"prompt_too_long"``)."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = Request(self._next_id, prompt, max_new_tokens, eos_token_id)
        self._next_id += 1
        req.submit_time = self._now()
        accepted, reason = self.scheduler.submit(req)
        if not accepted:
            req.state = RequestState.REJECTED
            req.reject_reason = reason
            self.metrics.record_rejection(req)
        return req

    # ------------------------------------------------------------------
    def _sample(self, logits) -> torch.Tensor:
        return self.engine.sample(logits, self._gen, self.temperature,
                                  self.top_k, self.top_p, self._greedy)

    def _defer(self, tensor: torch.Tensor, callback: Callable) -> None:
        """Run ``callback(host_list)`` after the step's one fetch."""
        self._deferred.append((tensor, callback))

    def _drain_deferred(self) -> None:
        pending, self._deferred = self._deferred, []
        for tensor, callback in pending:
            callback(tensor.tolist())  # the first fetch waits on the device

    @staticmethod
    def _bucket(n: int, cap: int) -> int:
        b = _MIN_PREFILL_BUCKET
        while b < n:
            b *= 2
        return min(b, cap)

    def _running_count(self) -> int:
        return sum(1 for r in self._slot_req.values()
                   if r.state is RequestState.RUNNING)

    def _admit(self, req: Request, finished: List[Request]) -> None:
        slot = self.pool.alloc()
        try:
            T = req.prompt_len
            width = self._bucket(T, self.pool.capacity)
            ids = np.zeros((1, width), np.int64)
            ids[0, :T] = req.prompt
            running_before = self._running_count()
            req.admit_time = self._now()
            logits, _ = self.engine.prefill_at(
                torch.as_tensor(ids, device=self.device), T - 1,
                cache=self.pool.cache, rows=[slot])
            self.pool.admit(slot, T)
            tok = self._sample(logits)
            self._cur[slot] = tok[0]
            self.metrics.record_prefill(T, self._now() - req.admit_time,
                                        blocking=running_before > 0)
            req.slot = slot
            self._slot_req[slot] = req
            req.state = RequestState.RUNNING

            def _on_first_token(tok, req=req, slot=slot):
                token = int(tok[0])
                req.first_token_time = self._now()
                req.output_tokens.append(token)
                self._maybe_retire(req, token, finished)

            self._defer(tok, _on_first_token)
        except Exception:
            # undo the partial admission so the request re-queues cleanly
            self._slot_req.pop(slot, None)
            self.pool.release(slot)
            req.state = RequestState.QUEUED
            req.slot = None
            req.admit_time = None
            raise

    def _decode_step(self, finished: List[Request], t0: float) -> None:
        running = [(slot, req) for slot, req in self._slot_req.items()
                   if req.state is RequestState.RUNNING]
        pos = torch.as_tensor(self.pool.positions(), device=self.device)
        logits = self.engine.decode(self.pool.cache, self._cur[:, None], pos)
        self.pool.advance(1)
        nxt = self._sample(logits)
        # every row's next current token is this decode's sample for it
        # (free rows hold values no live row ever reads)
        self._cur = nxt

        def _on_decode(nxt, running=running):
            emitted = 0
            for slot, req in running:
                if req.state is not RequestState.RUNNING:
                    continue  # retired by its first token in this drain
                token = int(nxt[slot])
                req.output_tokens.append(token)
                emitted += 1
                self._maybe_retire(req, token, finished)
            self.metrics.record_decode_step(emitted, len(running),
                                            step_s=self._now() - t0)

        self._defer(nxt, _on_decode)

    def _maybe_retire(self, req: Request, token: int,
                      finished: List[Request]) -> None:
        if req.eos_token_id is not None and token == req.eos_token_id:
            req.finish_reason = FinishReason.EOS
        elif len(req.output_tokens) >= req.max_new_tokens:
            req.finish_reason = FinishReason.LENGTH
        elif int(self.pool.starts[req.slot]) >= self.pool.capacity:
            req.finish_reason = FinishReason.LENGTH_CAP
        else:
            return
        req.state = RequestState.FINISHED
        req.finish_time = self._now()
        self.pool.release(req.slot)
        del self._slot_req[req.slot]
        self.metrics.record_finish(req)
        finished.append(req)

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One scheduler iteration: admit into free slots, then one decode
        step for every live slot. Returns the requests that finished.

        Exception-safe: if the engine raises mid-step, no slot leaks —
        granted-but-unadmitted requests go back to the head of the queue,
        seated ones are FAILED (reason ``"error"``), the pool is reset, and
        the error propagates."""
        finished: List[Request] = []
        self.step_id += 1
        t_step = self._now()
        running_at_entry = self._running_count()
        granted = self.scheduler.grant(self.pool.free_count, self.live_count)
        try:
            for req in granted:
                self._admit(req, finished)
            if self._running_count():
                self._decode_step(finished, self._now())
            self._drain_deferred()
        except Exception:
            self._abort_step(granted)
            raise
        if running_at_entry:
            # a running request waited through this whole step for its
            # next token: the user-visible inter-token gap
            self.metrics.record_step_gap(self._now() - t_step)
        return finished

    def _abort_step(self, granted: List[Request]) -> None:
        """Mid-step exception recovery: never leak a slot."""
        requeued = [r for r in granted if r.state is RequestState.QUEUED]
        self.scheduler.requeue_front(requeued)
        for req in self._slot_req.values():
            req.state = RequestState.FAILED
            req.finish_reason = FinishReason.ERROR
            req.finish_time = self._now()
            self.metrics.record_failure(req)
        self._slot_req.clear()
        self._deferred.clear()
        self._cur.zero_()
        self.pool.reset()

    def run_until_drained(self, max_steps: Optional[int] = None,
                          stall_patience: int = 32) -> List[Request]:
        """Step until the queue and every slot are empty (or ``max_steps``).
        A progress signature that stays identical for ``stall_patience``
        steps raises :class:`ServingStalledError` instead of spinning."""
        out: List[Request] = []
        steps = 0
        last_sig = None
        still = 0
        while self.scheduler.pending or self._slot_req:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
            sig = self._progress_signature()
            if sig == last_sig:
                still += 1
                if still >= stall_patience:
                    dump = self._stuck_dump()
                    raise ServingStalledError(
                        f"no progress for {still} consecutive steps "
                        f"(step_id={self.step_id}, pending="
                        f"{self.scheduler.pending}, live="
                        f"{self.live_count}); stuck requests: {dump}",
                        dump=dump)
            else:
                still = 0
                last_sig = sig
        return out

    def _progress_signature(self) -> tuple:
        return (self.scheduler.pending, len(self._slot_req),
                len(self.metrics.finished), self.metrics.failed,
                tuple(sorted((r.request_id, r.state.value,
                              len(r.output_tokens))
                             for r in self._slot_req.values())))

    def _stuck_dump(self) -> List[dict]:
        reqs = list(self._slot_req.values()) + list(self.scheduler.queue)
        return [{"request_id": r.request_id, "state": r.state.value,
                 "slot": r.slot, "seed_len": r.seed_len,
                 "new_tokens": len(r.output_tokens),
                 "max_new_tokens": r.max_new_tokens} for r in reqs]

    def check_invariants(self) -> None:
        """Audit engine/pool/scheduler bookkeeping; raises
        :class:`InvariantViolation` listing every violation: leaked or
        doubly-owned slots, a slot map that disagrees with its requests,
        seated or queued requests in the wrong state, lengths outside the
        allocation."""
        errors = list(self.pool.consistency_errors())
        seated = set(self._slot_req.keys())
        free = set(self.pool._free_set)
        both = seated & free
        if both:
            errors.append(f"slots both seated and free: {sorted(both)}")
        missing = set(range(self.pool.num_slots)) - seated - free
        if missing:
            errors.append(f"slots leaked (neither seated nor free): "
                          f"{sorted(missing)}")
        for slot, req in self._slot_req.items():
            if req.slot != slot:
                errors.append(f"slot map disagrees: _slot_req[{slot}] has "
                              f"req {req.request_id} with req.slot="
                              f"{req.slot}")
            if req.state is not RequestState.RUNNING:
                errors.append(f"seated req {req.request_id} in state "
                              f"{req.state.value}")
        for r in self.scheduler.queue:
            if r.state is not RequestState.QUEUED:
                errors.append(f"queued req {r.request_id} in state "
                              f"{r.state.value}")
            if r.slot is not None:
                errors.append(f"queued req {r.request_id} still holds "
                              f"slot {r.slot}")
        if np.any(self.pool.starts < 0) or \
                np.any(self.pool.starts[sorted(seated)] > self.pool.capacity):
            errors.append(f"cache lengths out of [0, {self.pool.capacity}]: "
                          f"{self.pool.starts.tolist()}")
        if errors:
            raise InvariantViolation(errors)

    def stats(self) -> dict:
        """Aggregate SLO snapshot (see ``ServingMetrics.snapshot``)."""
        return self.metrics.snapshot()
