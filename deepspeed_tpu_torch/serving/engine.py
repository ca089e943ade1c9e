"""ServingEngine: request-level continuous batching over InferenceEngine
(port of ``deepspeed_tpu/serving/engine.py``).

Requests arrive one at a time via :meth:`submit`. Each :meth:`step` grants
free slots to queued requests, seats them, runs at most one prefill chunk,
then runs ONE decode step for every running slot at batch = ``num_slots``
with per-slot cache offsets; finished sequences retire at once and their
slot goes back to work (Orca-style iteration-level scheduling). Sampled
tokens stay on the device during the step; one host fetch at the end of
the step replays the bookkeeping in dispatch order.

Admission. With ``prefill_chunk > 0`` (the default, 64, as in the JAX
engine) admission is stall-free (Sarathi-style): a seed longer than the
chunk is seated ``PREFILLING`` and streams in one chunk per step, and a
per-step prefill token budget bounds the admission work a running request
waits through. Shorter seeds are grouped by power-of-two bucket width and
each group is prefilled in one batched call. With ``prefill_chunk=0`` every
granted request is prefilled whole at admission (serial).

KV storage. ``paged_kv=False`` keeps one contiguous cache row per slot
(:class:`SlotPool`). ``paged_kv=True`` or a dict ``{"num_pages",
"page_size", "prefix_cache", "kernel"}`` stores the cache in a page pool
(:class:`PagedKVPool`): decode reads pages in place through the paged
attention kernel, requests sharing a prompt prefix are seated on the
cached pages (stall-free mode only: a hit enters the chunked path at its
first uncached position), admission is page-denominated, and a step that
runs out of pages preempts the youngest other request back to the queue.

Captured decode. With the inference config's ``enable_cuda_graph`` every
decode step replays a CUDA graph captured for the server's pool (one per
server: the batch is always ``num_slots``); the step writes the tokens
and positions into the graph's static buffers and samples after the
replay. ``overlap=True`` takes the pipelined order of the JAX engine: the
decode for the slots already running is issued first, then admission and
the prefill chunk, with one fetch at the end of the step; outcomes are the
serial step's.

Speculative decoding. With a ``spec_decode`` config the decode step is
draft-verify (``serving/spec_decode/``): a host-side drafter proposes up to
K tokens per running slot, one (num_slots, K+1) verify forward scores them
all (``InferenceEngine.verify_k`` on contiguous rows; ``PagedKVPool.
run_verify`` over pages, through the paged kernel for K+1 <= 8), and each
slot keeps its accepted prefix plus one bonus token. Rejected positions
roll back through the per-slot lengths (:meth:`SlotPool.advance`), never a
reshape, so speculation adds no shape; admission reserves K positions of
headroom (``capacity - k``). Greedy output is plain decoding's through
the same verify forward (in bf16 the one-row decode step rounds otherwise,
so the two can part where the top two logits tie). With
``enable_cuda_graph`` the verify forward is the server's one captured
step, and acceptance runs after its replay.

Recompiles. :attr:`watchdog` (``telemetry.RecompileWatchdog``) records one
signature per call of each watched entry point and every decode capture;
after :meth:`end_warmup` a new one counts as a recompile, and with
``strict_recompile`` the step boundary raises ``RecompileAfterWarmupError``
(after the step's fetch, so no request is failed by it).

The resilience and telemetry keys other than ``strict_recompile`` are later
slices; passing any of them raises ``NotImplementedError``. Speculation's
load-shedding branch (drafts suspended under overload) comes with them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..accelerator import copy_from_host
from ..ops.attention.paged_attention import MAX_QUERY_ROWS
from ..telemetry.watchdog import RecompileWatchdog
from ..utils.logging import log_dist
from .metrics import ServingMetrics
from .paged_pool import PagedKVPool, PagePoolExhausted
from .request import FinishReason, Request, RequestState
from .resilience.errors import InvariantViolation, ServingStalledError
from .resilience.preemption import select_victims
from .scheduler import FIFOScheduler
from .slot_pool import SlotPool
from .spec_decode import SpecDecodeConfig, make_drafter

_MIN_PREFILL_BUCKET = 16

# serving keys of the JAX engine that this port does not have yet; None or
# False means "off" and is accepted, any other value raises
NOT_PORTED = ("tracer", "registry", "timeline_capacity",
              "deadline_default_ms", "step_wall_budget_ms", "guard_numerics",
              "degradation", "preempt_queue_threshold",
              "preempt_min_run_steps", "fault_injector", "cost_model", "slo",
              "flight_recorder", "dump_dir", "priority", "clock", "role")

# the port's counterparts of the entry points the JAX watchdog wraps
# (_WATCHED_ENGINE_JITS, _WATCHED_POOL_JITS); the paged ones exist only
# on a PagedKVPool (attach skips absentees). A captured decode or verify
# step records through DecodeGraphs.capture, on every call
_WATCHED_ENGINE = ("prefill_at", "prefill_chunk", "decode", "decode_paged",
                   "sample", "verify_k")
_WATCHED_POOL = ("admit_rows", "run_decode", "run_prefill_chunk",
                 "run_verify", "_copy_page")
# a model drafter's engine programs (the JAX _WATCHED_DRAFTER_JITS: the
# draft model's prefill and decode run every step too)
_WATCHED_DRAFTER = ("prefill_at", "decode")

PAGED_KV_KEYS = ("num_pages", "page_size", "prefix_cache", "kernel")


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
                 prefill_chunk: int = 64,
                 prefill_token_budget: Optional[int] = None,
                 paged_kv: Any = False, strict_recompile: bool = False,
                 overlap: bool = False, spec_decode: Any = None,
                 **not_ported: Any):
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
        self.engine = engine
        self._now = time.perf_counter
        self.device = engine.device
        spec = engine.kv_cache_spec()
        capacity = int(spec.max_seq_len)
        # chunk starts are multiples of the chunk width, so capacity %
        # chunk == 0 keeps every chunk inside the allocation; auto-halve
        # (the width is a latency knob, not a correctness contract)
        chunk = min(int(prefill_chunk), capacity)
        while chunk > 1 and capacity % chunk != 0:
            chunk //= 2
        if paged_kv:
            knobs = dict(paged_kv) if isinstance(paged_kv, dict) else {}
            unknown = sorted(set(knobs) - set(PAGED_KV_KEYS))
            if unknown:
                raise ValueError(f"unknown paged_kv keys: {unknown}; "
                                 f"expected {'/'.join(PAGED_KV_KEYS)}")
            page_size = knobs.get("page_size")
            if page_size is None:
                # one chunk fills one page
                page_size = chunk if chunk > 0 else 64
                page_size = max(1, min(page_size, capacity))
                while page_size > 1 and capacity % page_size != 0:
                    page_size //= 2
            self.pool = PagedKVPool(
                spec, num_slots, num_pages=knobs.get("num_pages"),
                page_size=int(page_size), device=self.device,
                prefix_cache=bool(knobs.get("prefix_cache", True)),
                kernel=str(knobs.get("kernel", "auto")))
        else:
            self.pool = SlotPool(spec, num_slots, self.device)
        self._paged = isinstance(self.pool, PagedKVPool)
        self._spec: Optional[SpecDecodeConfig] = None
        self._drafter = None
        sched_capacity = self.pool.capacity
        sc = SpecDecodeConfig.from_value(spec_decode)
        if sc is not None and sc.enabled:     # False / enabled=False: off
            sc.validate(self.pool.capacity)
            self._spec = sc
            self._drafter = make_drafter(sc)
            # verify writes k+1 positions past a slot's length (the
            # rejected tail is masked padding); reserving k of them at
            # admission keeps even a fully rejected chunk inside the
            # allocation, clear of any other request's positions
            sched_capacity = self.pool.capacity - sc.k
        graphs = getattr(engine, "decode_graphs", None)
        if graphs is not None and self._paged and not self.pool.kernel_active:
            raise ValueError(
                "enable_cuda_graph captures the paged decode step through "
                "the paged kernel; paged_kv kernel='off' builds a dense "
                "view of the pages at every step, which cannot be captured")
        if graphs is not None and self._paged and self._spec is not None \
                and self._spec.k + 1 > MAX_QUERY_ROWS:
            raise ValueError(
                f"enable_cuda_graph captures the paged verify step through "
                f"the paged kernel, which takes k+1 <= {MAX_QUERY_ROWS} query "
                f"rows; spec_decode.k={self._spec.k} verifies over a dense "
                f"view of the pages, which cannot be captured")
        self.scheduler = FIFOScheduler(
            num_slots, max_queue_depth, policy, capacity=sched_capacity,
            page_size=self.pool.page_size if self._paged else None,
            num_pages=self.pool.num_pages if self._paged else None,
            page_headroom=self._spec.k if self._spec is not None else 0)
        self._stall_free = chunk > 0 and policy == "continuous"
        self.prefill_chunk = chunk if self._stall_free else 0
        self.prefill_token_budget = None
        if self._stall_free:
            budget = (2 * chunk if prefill_token_budget is None
                      else int(prefill_token_budget))
            if budget < chunk:
                raise ValueError(
                    f"prefill_token_budget ({budget}) must be >= "
                    f"prefill_chunk ({chunk}); a smaller budget could never "
                    f"schedule the in-flight chunk")
            self.prefill_token_budget = budget
        # prefix-hit seating enters the chunked path at the first uncached
        # position, so it needs stall-free mode
        self._use_prefix = (self._paged and self.pool.prefix is not None
                            and self._stall_free)
        # seated PREFILLING requests, in order; step() advances the head
        self._prefill_queue: List[Request] = []
        self.step_id = 0
        self.metrics = ServingMetrics(monitor, step_fn=lambda: self.step_id)
        self._overlap = bool(overlap)
        self.watchdog = RecompileWatchdog(strict=bool(strict_recompile),
                                          step_fn=lambda: self.step_id)
        for attr in _WATCHED_ENGINE:
            self.watchdog.attach(engine, attr,
                                 name=f"InferenceEngine.{attr}")
        for attr in _WATCHED_POOL:
            self.watchdog.attach(self.pool, attr, name=f"SlotPool.{attr}")
        if graphs is not None:
            self.watchdog.attach(graphs, "capture",
                                 name="DecodeGraphs.capture",
                                 every_call=True)
        draft_engine = getattr(self._drafter, "engine", None)
        if draft_engine is not None:
            for attr in _WATCHED_DRAFTER:
                self.watchdog.attach(draft_engine, attr,
                                     name=f"Drafter.{attr}")
            draft_graphs = getattr(draft_engine, "decode_graphs", None)
            if draft_graphs is not None:
                self.watchdog.attach(draft_graphs, "capture",
                                     name="Drafter.capture", every_call=True)
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
        if self._spec is not None:
            # the step's drafts on the device, uploaded in place
            self._draft = torch.zeros((num_slots, self._spec.k),
                                      dtype=torch.long, device=self.device)
            self._draft_len = torch.zeros((num_slots,), dtype=torch.long,
                                          device=self.device)
        # (device tensor, callback) pairs replayed after the step's fetch
        self._deferred: List[Tuple[torch.Tensor, Callable]] = []
        self._next_id = 0
        admission = (f"stall-free chunk={self.prefill_chunk} "
                     f"budget={self.prefill_token_budget}"
                     if self._stall_free else "serial")
        storage = (f"paged page_size={self.pool.page_size} "
                   f"num_pages={self.pool.num_pages} "
                   f"prefix_cache={self.pool.prefix is not None} "
                   f"kernel={self.pool.kernel}" if self._paged
                   else "contiguous")
        log_dist(f"ServingEngine: slots={num_slots} policy={policy} "
                 f"capacity={self.pool.capacity} "
                 f"max_queue_depth={max_queue_depth} admission={admission} "
                 f"kv={storage} cuda_graph={graphs is not None} "
                 f"overlap={self._overlap} spec_k="
                 f"{self._spec.k if self._spec is not None else 0}",
                 ranks=[0])

    # ------------------------------------------------------------------
    @property
    def live_count(self) -> int:
        return len(self._slot_req)

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def end_warmup(self) -> None:
        """Declare warmup traffic over: from here on a new signature or
        capture counts against :attr:`watchdog` ``.recompiles`` (and, with
        ``strict_recompile``, raises at the next step boundary)."""
        self.watchdog.end_warmup()

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

    def _seat(self, req: Request, slot: int, state: RequestState) -> None:
        req.slot = slot
        req.state = state
        req.last_admit_step = self.step_id
        self._slot_req[slot] = req

    def _emit_first(self, req: Request, token: int,
                    finished: List[Request]) -> None:
        """Host replay of a request's token sampled at the end of its
        prefill (its first, or the next one after a preemption)."""
        if req.first_token_time is None:
            req.first_token_time = self._now()
        req.output_tokens.append(token)
        self._maybe_retire(req, token, finished)

    # -- admission -------------------------------------------------------
    def _admit_batch(self, group: List[Request], width: int,
                     finished: List[Request]) -> None:
        """Whole-seed admission of ``group`` (same bucket ``width``) in one
        ``prefill_at`` call projecting each seed's true last position, the
        K/V going straight into the slots (contiguous rows, or pages
        through :meth:`PagedKVPool.admit_rows`). Rolls the whole group
        back to clean QUEUED requests on an exception."""
        n = len(group)
        ids = np.zeros((n, width), np.int64)
        last_pos = np.zeros((n,), np.int64)
        lengths = np.zeros((n,), np.int64)
        slots: List[int] = []
        running_before = self._running_count()
        # rollback snapshots: a preempted request keeps its tokens/stamps
        n0s = [len(r.output_tokens) for r in group]
        stamps = [(r.admit_time, r.first_token_time) for r in group]
        try:
            for i, req in enumerate(group):
                T = req.seed_len
                ids[i, :T] = req.seed_tokens
                last_pos[i] = T - 1
                lengths[i] = T
                req.admit_time = self._now()
                slots.append(self.pool.alloc())
            t0 = self._now()
            cache, rows = self.pool.prefill_target(slots, width)
            logits, _ = self.engine.prefill_at(
                torch.as_tensor(ids, device=self.device), last_pos,
                cache=cache, rows=rows)
            self.pool.admit_rows(cache, slots, lengths)
            tok = self._sample(logits)
            self._cur[torch.as_tensor(slots, device=self.device)] = tok
            self.metrics.record_prefill(int(lengths.sum()), self._now() - t0,
                                        blocking=running_before > 0)
            for req, slot in zip(group, slots):
                self._seat(req, slot, RequestState.RUNNING)
                if self._use_prefix:
                    self.pool.cache_prefix(slot, req.seed_tokens)

            def _on_tokens(tok, group=group):
                for req, token in zip(group, tok):
                    self._emit_first(req, int(token), finished)

            self._defer(tok, _on_tokens)
        except Exception:
            for i, req in enumerate(group):
                if i < len(slots):
                    self._slot_req.pop(slots[i], None)
                    self.pool.release(slots[i])
                req.state = RequestState.QUEUED
                req.slot = None
                req.admit_time, req.first_token_time = stamps[i]
                del req.output_tokens[n0s[i]:]
            raise

    def _admission_cost(self, req: Request) -> int:
        """Prefill tokens a grant charges against the step budget: the
        bucket width for a whole-seed admission, one chunk for a long seed
        (only its first chunk can run this step)."""
        T = req.seed_len
        if T <= self.prefill_chunk:
            return self._bucket(T, self.pool.capacity)
        return self.prefill_chunk

    # -- paged KV: page accounting and prefix-hit seating --------------
    def _prefix_plan(self, hit_tokens: int, seed_len: int) -> int:
        """Where a prefix-hit admission starts prefilling. A full hit still
        prefills the LAST chunk again (its logits sample the next token,
        as a cold chunked admission's do), and the start is aligned down
        to a chunk multiple so every chunk stays inside the allocation."""
        C = max(self.prefill_chunk, 1)
        if hit_tokens >= seed_len:
            pos0 = seed_len - min(C, seed_len)
        else:
            pos0 = min(hit_tokens, seed_len)
        return (pos0 // C) * C

    def _page_cost(self, req: Request) -> int:
        """FRESH pages seating ``req`` allocates now: those covering its
        uncached suffix (CoW forks included; shared prefix pages cost a
        refcount). Decode-time growth is not charged: that is the
        oversubscription bet, covered by trie eviction and pressure
        preemption."""
        ps = self.pool.page_size
        seed = req.seed_len
        pos0 = 0
        if self._use_prefix:
            hit = self.pool.prefix.peek(req.seed_tokens) * ps
            pos0 = self._prefix_plan(hit, seed)
        return (seed - 1) // ps - pos0 // ps + 1

    def _grant_page_budget(self) -> int:
        """Pages a grant may promise this step: free now, plus what trie
        eviction could reclaim without preempting anyone."""
        return self.pool.free_page_count + self.pool.evictable_page_count()

    def _ensure_pages(self, slot: int, start: int, end: int) -> None:
        """``ensure_writable`` with the pressure valve: when the pool is
        exhausted (free list empty AND trie eviction dry), preempt the
        youngest OTHER seated request, whose pages return to the free
        list, and retry. Only with no victim left does the exhaustion
        propagate (one request's footprint exceeding the whole pool,
        which the submit-time page check rejects)."""
        while True:
            try:
                self.pool.ensure_writable(slot, start, end)
                return
            except PagePoolExhausted:
                victims = [r for r in select_victims(
                    list(self._slot_req.values()), n=len(self._slot_req),
                    current_step=self.step_id, min_run_steps=0)
                    if r.slot != slot]
                if not victims:
                    raise
                self._preempt_req(victims[0])

    def _ensure_decode_pages(self, width: int) -> None:
        """Back every RUNNING slot's next ``width`` write positions (1 for
        decode, K+1 for verify) with owned pages before the step.
        PREFILLING slots are skipped: their ``width`` masked garbage writes
        start at their chunk offset, and every page at or past it is either
        unmapped (the write goes to the scratch page) or owned by the slot
        (allocated for an earlier chunk, or forked by the prefix seating,
        which forks every mapped page from the offset on); the next chunk
        overwrites them."""
        for slot, req in list(self._slot_req.items()):
            if req.state is RequestState.RUNNING:
                idx = int(self.pool.starts[slot])
                self._ensure_pages(slot, idx, idx + width)

    def _admit_prefix_hit(self, req: Request) -> bool:
        """Try to seat ``req`` through the prefix cache: map the cached
        pages into a fresh slot and enter the chunked path at the first
        uncached position. Returns False on a miss (the caller takes the
        cold paths)."""
        pool = self.pool
        seed_len = req.seed_len
        pages = pool.prefix.match(req.seed_tokens)
        pos0 = self._prefix_plan(len(pages) * pool.page_size, seed_len)
        self.metrics.record_prefix(pos0, seed_len)
        if pos0 <= 0:
            return False
        now = self._now()     # before alloc: nothing may fail while the
        slot = pool.alloc()   # slot is held but not yet seated
        try:
            pool.reset_row(slot)
            pool.seat_prefix(slot, pages, pos0)
        except PagePoolExhausted:
            # the uncached suffix needs more fresh pages than remain:
            # release (unmapping anything seated so far) and retry next
            # step, once eviction or preemption has freed pages
            pool.release(slot)
            self.scheduler.requeue_front([req])
            return True
        except Exception:
            pool.release(slot)
            req.state = RequestState.QUEUED
            raise
        req.admit_time = now
        req.prefill_pos = pos0
        req.prefix_hit_tokens = pos0
        self._seat(req, slot, RequestState.PREFILLING)
        self._prefill_queue.append(req)
        return True

    def _admit_stall_free(self, granted: List[Request],
                          finished: List[Request]) -> None:
        """Seat every granted request: prefix hits and long seeds become
        PREFILLING (their pages or rows fill chunk by chunk in later
        steps); short seeds are grouped by bucket width and each group is
        prefilled in one batched call."""
        groups: dict = {}
        for req in granted:
            if self._use_prefix and self._admit_prefix_hit(req):
                continue
            T = req.seed_len
            if T > self.prefill_chunk:
                now = self._now()
                slot = self.pool.alloc()
                try:
                    self.pool.reset_row(slot)
                except Exception:
                    self.pool.release(slot)
                    raise
                req.admit_time = now
                req.prefill_pos = 0
                self._seat(req, slot, RequestState.PREFILLING)
                self._prefill_queue.append(req)
            else:
                groups.setdefault(self._bucket(T, self.pool.capacity),
                                  []).append(req)
        for width in sorted(groups):
            self._admit_batch(groups[width], width, finished)

    def _prefill_chunk_step(self, finished: List[Request]) -> None:
        """Run AT MOST one prefill chunk, for the head of the prefill
        queue, so a step's admission work stays bounded however long the
        queued prompts are. The final chunk projects the seed's true last
        position, samples its token and flips the request to RUNNING."""
        if not self._prefill_queue:
            return
        req = self._prefill_queue[0]
        slot = req.slot
        C = self.prefill_chunk
        pos = req.prefill_pos
        seed = req.seed_tokens
        seed_len = req.seed_len
        L = min(C, seed_len - pos)
        ids = np.zeros((1, C), np.int64)
        ids[0, :L] = seed[pos:pos + L]
        running_before = self._running_count()
        t0 = self._now()
        if self._paged:
            # the chunk's pages are allocated or forked before it runs
            # (under pressure this may preempt another request)
            self._ensure_pages(slot, pos, pos + L)
            logits = self.pool.run_prefill_chunk(self.engine, ids, slot, pos,
                                                 L - 1)
        else:
            logits = self.engine.prefill_chunk(self.pool.cache, ids, slot,
                                               pos, L - 1)
        self.pool.starts[slot] = pos + L
        req.prefill_pos = pos + L
        req.chunks += 1
        self.metrics.record_prefill(L, self._now() - t0,
                                    blocking=running_before > 0)
        if req.prefill_pos < seed_len:
            return
        tok = self._sample(logits)
        self._cur[slot] = tok[0]
        self._prefill_queue.pop(0)
        req.state = RequestState.RUNNING
        req.last_admit_step = self.step_id
        if self._use_prefix:
            self.pool.cache_prefix(slot, seed)
        self._defer(tok, lambda tok, req=req: self._emit_first(
            req, int(tok[0]), finished))

    # -- decode and retirement -----------------------------------------
    def _decode_step(self, finished: List[Request], t0: float) -> None:
        if self._paged:
            # page the write position in BEFORE snapshotting the running
            # set: under pressure this can preempt a victim out of it
            self._ensure_decode_pages(1)
        running = [(slot, req) for slot, req in self._slot_req.items()
                   if req.state is RequestState.RUNNING]
        pos = self.pool.positions_dev()
        tokens = self._cur[:, None]
        if self._paged:
            logits = self.pool.run_decode(self.engine, tokens, pos)
        else:
            logits = self.engine.decode(self.pool.cache, tokens, pos)
        # only running rows grew; PREFILLING rows rode along as masked
        # padding and keep their chunk offsets
        deltas = np.zeros((self.pool.num_slots,), np.int32)
        deltas[[slot for slot, _ in running]] = 1
        self.pool.advance(deltas)
        nxt = self._sample(logits)
        # every row's next current token is this decode's sample for it
        # (other rows hold values no live row ever reads); in place, so
        # the token vector keeps its address
        self._cur.copy_(nxt)

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

    def _spec_decode_step(self, finished: List[Request], t0: float) -> None:
        """Draft K tokens per running slot, verify them all in ONE
        fixed-shape (num_slots, K+1) forward, keep each slot's accepted
        prefix + bonus token, and roll back the rejected positions through
        the per-slot lengths."""
        K = self._spec.k
        B = self.pool.num_slots
        if self._paged:
            # verify writes K+1 columns past every RUNNING slot's length:
            # page them in first (under pressure this may preempt, so
            # before the drafter snapshots the live set)
            self._ensure_decode_pages(K + 1)
        if self._deferred:
            # admissions sampled first tokens earlier in THIS step (the
            # serial order): the drafter's host histories need them, so
            # settle them now. Steady decode steps, and overlap mode,
            # which verifies before admitting, keep one fetch a step
            self._drain_deferred()
        # PREFILLING and free slots keep histories None: draft_len 0, and
        # their deltas stay 0 below, so verify's masked writes roll back
        histories: List[Optional[np.ndarray]] = [None] * B
        for slot, req in self._slot_req.items():
            if req.state is RequestState.RUNNING:
                histories[slot] = req.tokens()
        draft, draft_len = self._drafter.propose(histories, K)
        draft = np.asarray(draft, np.int64)
        draft_len = np.clip(np.asarray(draft_len, np.int64), 0, K)
        t_draft = self._now() - t0
        # stream-ordered uploads into static buffers: no host sync
        copy_from_host(self._draft, draft)
        copy_from_host(self._draft_len, draft_len)
        tokens = torch.cat([self._cur[:, None], self._draft], dim=1)
        args = (tokens, self.pool.positions_dev(), self._draft,
                self._draft_len, self._gen, self.temperature, self._greedy,
                self.top_k, self.top_p)
        if self._paged:
            out, n_emit = self.pool.run_verify(self.engine, *args)
        else:
            out, n_emit = self.engine.verify_k(self.pool.cache, *args)
        # the next current token of row b is its last EMITTED one,
        # out[b, n_emit[b] - 1] (masked rows: never read); in place, so
        # the token vector keeps its address for the captured step
        self._cur.copy_(out.gather(1, (n_emit - 1).clamp(min=0)[:, None])
                        [:, 0])
        live = [(slot, req) for slot, req in self._slot_req.items()
                if req.state is RequestState.RUNNING]

        def _on_verify(fetched, live=live, draft_len=draft_len):
            deltas = np.zeros((B,), np.int32)
            emitted = drafted = accepted = 0
            for slot, req in live:
                if req.state is not RequestState.RUNNING:
                    continue  # retired by its first token in this drain
                row = fetched[slot]
                e = row[-1]
                # the row holds e new positions whatever the request
                # consumes below: an eos or budget cut retires it this
                # step, and the surplus becomes padding of a freed slot
                deltas[slot] = e
                drafted += int(draft_len[slot])
                accepted += e - 1
                req.spec_drafted += int(draft_len[slot])
                req.spec_accepted += e - 1
                for token in row[:e]:
                    req.output_tokens.append(token)
                    emitted += 1
                    self._maybe_retire(req, token, finished)
                    if req.state is not RequestState.RUNNING:
                        break
            self.pool.advance(deltas)       # per-slot KV rollback
            self.metrics.record_decode_step(
                emitted, len(live), drafted=drafted, accepted=accepted,
                draft_s=t_draft, step_s=self._now() - t0)

        # one fetch: the emitted tokens with their counts in a last column
        self._defer(torch.cat([out, n_emit[:, None]], dim=1), _on_verify)

    def _maybe_retire(self, req: Request, token: int,
                      finished: List[Request]) -> None:
        if req.eos_token_id is not None and token == req.eos_token_id:
            req.finish_reason = FinishReason.EOS
        elif len(req.output_tokens) >= req.max_new_tokens:
            req.finish_reason = FinishReason.LENGTH
        elif req.slot is not None and \
                int(self.pool.starts[req.slot]) >= self.pool.capacity:
            req.finish_reason = FinishReason.LENGTH_CAP
        else:
            # a request preempted in the step that sampled this token
            # waits in the queue; the token is now part of its seed
            return
        req.state = RequestState.FINISHED
        req.finish_time = self._now()
        if req.slot is None:
            # preempted in the step that sampled its last token: it holds
            # no slot, only its place in the queue
            self.scheduler.queue.remove(req)
        else:
            self.pool.release(req.slot)
            del self._slot_req[req.slot]
        self.metrics.record_finish(req)
        finished.append(req)

    def _preempt_req(self, req: Request) -> None:
        """Page-pressure preemption: release ``req``'s slot and pages and
        requeue it at the TAIL with its generated tokens (re-queueing at
        the head would hand it back its own pages at the next grant,
        forever)."""
        del self._slot_req[req.slot]
        self.pool.release(req.slot)
        req.slot = None
        self._prefill_queue[:] = [r for r in self._prefill_queue
                                  if r is not req]
        req.prefill_pos = 0
        req.admit_time = None
        req.preemptions += 1
        self.scheduler.requeue_back([req])
        self.metrics.record_preemption(req)

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One scheduler iteration: admit into free slots, run at most one
        prefill chunk, then one decode step for every running slot (with
        ``overlap``: the decode for the slots running at entry first, then
        admission and the chunk; slots admitted this step join the decode
        next step). Returns the requests that finished.

        Exception-safe: if the engine raises mid-step, no slot or page
        leaks. Granted-but-unadmitted and PREFILLING requests go back to
        the head of the queue, running ones are FAILED (reason
        ``"error"``), the pool is reset, and the error propagates. The
        strict recompile check runs after the step, at its boundary, and
        fails no request."""
        finished: List[Request] = []
        self.step_id += 1
        t_step = self._now()
        running_at_entry = self._running_count()
        page_budget = self._grant_page_budget() if self._paged else None
        page_cost = self._page_cost if self._paged else None
        if self._stall_free:
            # one chunk for the prefill-queue head runs this step: charge
            # it up front so admissions + chunk stay within the budget
            granted = self.scheduler.grant(
                self.pool.free_count, self.live_count,
                token_budget=self.prefill_token_budget,
                cost=self._admission_cost,
                spent=self.prefill_chunk if self._prefill_queue else 0,
                page_budget=page_budget, page_cost=page_cost)
        else:
            granted = self.scheduler.grant(
                self.pool.free_count, self.live_count,
                page_budget=page_budget, page_cost=page_cost)
        try:
            decode = (self._spec_decode_step if self._spec is not None
                      else self._decode_step)
            decoded = False
            if self._overlap and self._running_count():
                # pipelined order: the running slots' decode (or draft +
                # verify) is issued first, so admission's host work
                # overlaps it on the card
                decode(finished, self._now())
                decoded = True
            if self._stall_free:
                self._admit_stall_free(granted, finished)
                self._prefill_chunk_step(finished)
            else:
                for req in granted:
                    self._admit_batch(
                        [req], self._bucket(req.seed_len, self.pool.capacity),
                        finished)
            if not decoded and self._running_count():
                decode(finished, self._now())
            self._drain_deferred()
        except Exception:
            self._abort_step(granted)
            raise
        # the strict recompile gate sits at the step boundary: raising
        # mid-step would abort the step and FAIL requests whose state is
        # consistent
        self.watchdog.check()
        if running_at_entry:
            # a running request waited through this whole step for its
            # next token: the user-visible inter-token gap
            self.metrics.record_step_gap(self._now() - t_step)
        return finished

    def _abort_step(self, granted: List[Request]) -> None:
        """Mid-step exception recovery: never leak a slot or a page.
        Requests the failed admission rolled back re-join the queue head;
        PREFILLING requests lose only cache state their seed rebuilds, so
        they are requeued too (ahead of the granted ones: they are older);
        running requests are FAILED; the pool restarts empty."""
        # a granted request that page pressure already sent back to the
        # queue this step is QUEUED too: requeue only those not there
        self.scheduler.requeue_front(
            [r for r in granted if r.state is RequestState.QUEUED
             and all(r is not q for q in self.scheduler.queue)])
        prefilling = sorted((r for r in self._slot_req.values()
                             if r.state is RequestState.PREFILLING),
                            key=lambda r: r.request_id)
        for req in prefilling:
            del self._slot_req[req.slot]
            req.slot = None
            req.admit_time = None
            req.prefill_pos = 0
        self.scheduler.requeue_front(prefilling)
        self._prefill_queue.clear()
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
                              len(r.output_tokens), r.prefill_pos)
                             for r in self._slot_req.values())))

    def _stuck_dump(self) -> List[dict]:
        reqs = list(self._slot_req.values()) + list(self.scheduler.queue)
        return [{"request_id": r.request_id, "state": r.state.value,
                 "slot": r.slot, "prefill_pos": r.prefill_pos,
                 "seed_len": r.seed_len,
                 "new_tokens": len(r.output_tokens),
                 "max_new_tokens": r.max_new_tokens,
                 "preemptions": r.preemptions} for r in reqs]

    def check_invariants(self) -> None:
        """Audit engine/pool/scheduler bookkeeping; raises
        :class:`InvariantViolation` listing every violation: the pool's
        own audit (with paged KV: refcounts against held references,
        leaked pages, unbacked live positions), leaked or doubly-owned
        slots, a slot map that disagrees with its requests, seated or
        queued requests in the wrong state, a prefill queue that disagrees
        with the PREFILLING requests, lengths outside the allocation."""
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
            if req.state not in (RequestState.RUNNING,
                                 RequestState.PREFILLING):
                errors.append(f"seated req {req.request_id} in state "
                              f"{req.state.value}")
        prefilling = sorted(r.request_id for r in self._slot_req.values()
                            if r.state is RequestState.PREFILLING)
        queued = sorted(r.request_id for r in self._prefill_queue)
        if prefilling != queued:
            errors.append(f"PREFILLING seated requests {prefilling} != "
                          f"prefill queue {queued}")
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
        """Aggregate SLO snapshot (see ``ServingMetrics.snapshot``) and
        ``spec_k`` (the draft length, 0 with speculation off); with paged
        KV a ``"paging"`` sub-dict carries the page-pool and prefix-cache
        counters (``PagedKVPool.page_stats``)."""
        snap = self.metrics.snapshot()
        snap["spec_k"] = int(self._spec.k) if self._spec is not None else 0
        if self._paged:
            snap["paging"] = self.pool.page_stats()
        return snap
