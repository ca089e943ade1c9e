"""ServingEngine: request-level continuous batching over InferenceEngine
(port of ``deepspeed_tpu/serving/engine.py``).

Requests arrive one at a time via :meth:`submit`. Each :meth:`step` grants
free slots to queued requests, seats them, runs at most one prefill chunk,
then runs ONE decode step for every running slot at batch = ``num_slots``
with per-slot cache offsets; finished sequences retire at once and their
slot goes back to work (Orca-style iteration-level scheduling). Sampled
tokens stay on the device during the step; one host fetch at the end of
the step brings every deferred token and flag back at once and replays the
bookkeeping in dispatch order.

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

FAULT TOLERANCE (the :mod:`.resilience` package) hardens the loop without
changing a shape or capturing a new graph:

* per-request deadlines (``submit(..., deadline_ms=...)``, or
  ``deadline_default_ms``) expire queued requests before they cost a
  prefill and retire seated ones through the slot release
  (``finish_reason="deadline"``); :meth:`cancel` retires a request the
  same way (``"cancelled"``);
* :meth:`preempt` evicts a seated request and re-queues it at the head with
  its generated tokens; its next admission prefills prompt + outputs
  through the same bucketed/chunked paths, and greedy output is unchanged.
  With ``preempt_queue_threshold``, a queue past the threshold with every
  slot (or page) taken evicts one victim a step (lowest priority class,
  then youngest; seated at least ``preempt_min_run_steps`` steps), to the
  BACK of the queue;
* a HEALTHY/PRESSURED/OVERLOADED load-state machine (``degradation``)
  halves the prefill token budget, then pins it at one chunk, suspends
  speculative drafting (zero-length drafts through the same verify forward
  and its captured graph) and sheds new submissions with ``retry_after``;
* ``guard_numerics`` checks every decode row's logits for NaN/inf after
  the decode (after a replay, outside the graph) and fails ONLY the
  poisoned slot (``finish_reason="numerical_error"``); the (num_slots,)
  flags ride the step's one fetch beside the tokens;
* a seeded :class:`~.resilience.FaultInjector` (``fault_injector``) threads
  deterministic failures through the engine's named points
  (``admit_oom``, ``drafter_error``, ``nan_logits``, ``step_host_error``,
  ``slow_dispatch``, ``state_corruption``) for chaos tests;
* ``priority`` (True or a ``PriorityConfig``) swaps the FIFO scheduler for
  :class:`~.frontend.priority.PriorityScheduler`: classes, fair-share
  prefill budgets, tenant rate limits and quotas, and burn-rate shedding
  and preemption of lower classes when an SLO class burns.

TELEMETRY (the ``telemetry`` package): a :class:`~..telemetry.Tracer`
(``tracer``; disabled by default, when a span costs one branch) records
the step's phases as host spans (``serving/step``, ``serving/grant``,
``serving/admit``, ``serving/prefill_batch``, ``serving/prefill_chunk``,
``serving/decode``, ``serving/sample``, ``serving/draft``,
``serving/verify_k``) that time host dispatch, as the JAX spans do: no
span synchronizes the card. Per-request lifecycle events go to a bounded
:class:`~..telemetry.TimelineStore` (``timeline_capacity``, on by
default), counters, gauges and histograms to a
:class:`~..telemetry.MetricsRegistry` (``registry``), SLO windows, goodput
and burn alerts to a :class:`~..telemetry.SLOTracker` (``slo``), and one
record a step to a :class:`~..telemetry.FlightRecorder` (on by default),
which writes a post-mortem JSON into ``dump_dir`` when the engine raises a
stall, an invariant violation or a strict recompile. Every time-dependent
decision (deadlines, expiry, SLO latencies, load-state windows, rate
buckets) reads one clock, ``clock`` (``time.perf_counter`` by default).

Recompiles. :attr:`watchdog` (``telemetry.RecompileWatchdog``) records one
signature per call of each watched entry point and every decode capture;
after :meth:`end_warmup` a new one counts as a recompile, and with
``strict_recompile`` the step boundary raises ``RecompileAfterWarmupError``
(after the step's fetch, so no request is failed by it).

Efficiency. ``cost_model`` (False by default; True, a
``telemetry.ProgramCostModel`` kwargs dict or an instance) charges every
watched program call its analytic flops and bytes
(``telemetry/costs.py``); each step folds them into MFU, bandwidth
utilization and tokens per GFLOP against its wall time, and every
``kv_every`` steps reconciles the pool's KV bytes against the spec's.
:meth:`efficiency_snapshot` rolls the cost model, the SLO tracker and the
instrumentation's own overhead up; :meth:`reset_efficiency_window` starts
a measured window after warmup.

Tensor parallelism. Over an engine whose model group has N > 1 ranks
(``InferenceEngine.mp_world_size``), every rank runs its own server over
its shard, fed the same submissions in the same order (SPMD): its pools
hold the rank's KV heads (the engine's ``kv_cache_spec``), the page table,
free list and prefix trie are host state and stay whole on every rank,
and sampling reads the whole gathered logits with a generator seeded the
same on every rank, so every decision is the same on every rank. Beside
``data`` > 1 ranks (a ``(data, model)`` mesh) the contiguous pool's slots
are split over the data ranks and each step's logits assembled over them;
the paged pool stays whole and every data rank computes every slot
(``model_group.py``). The server's clock is one clock over the world:
every reading is rank 0's (``model_group.GroupClock``), so every clocked
key (deadlines, the wall budget, degradation, priority, the SLO) decides
alike on every rank. The numerics guard fails a row on every rank when it
is poisoned on one. Twice a step the ranks compare a digest of the step's
decisions over the world (after the grant: the granted request ids and
the queue; at the step boundary: the retired ids and reasons, every
seated request's token count and last sampled token); a mismatch raises
:class:`RankDivergenceError` on every rank at that point, before a
diverged step could issue a collective the other ranks do not. Every
serving key runs above one rank; ``overlap``'s pipelined order, the
speculative drafters and verify, the disaggregated roles (each rank moves
its own KV-head shard of a page between the two pools it holds) and the
cost model (a rank's share of the flops and bytes) included.

Disaggregated prefill/decode (``role``, the DistServe/Splitwise split):
``"both"`` is the colocated engine; ``"prefill"`` admits and prefills
only, and parks each request once its pages are full and its first token
sampled (:meth:`pending_handoffs`); ``"decode"`` also takes requests whose
prefill ran on another replica (:meth:`adopt`: their live pages copied
across pools by :meth:`PagedKVPool.import_pages`, trie-hit pages mapped
instead, the decode resumed at the source's position), after which the
source releases its seat (:meth:`finish_handoff`). Roles other than
``"both"`` need ``paged_kv``: pages are the unit a handoff moves. A role
changes no shape and no captured step; a prefill replica never runs the
decode. :class:`~.router.ReplicaRouter` drives the handoffs and stamps
:attr:`replica_id` (every timeline event then carries it).
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import comm
from ..accelerator import copy_from_host
from ..ops.attention.paged_attention import MAX_QUERY_ROWS
from ..telemetry import (FlightRecorder, MetricsRegistry,
                         ProgramCostModel, RecompileAfterWarmupError,
                         RecompileWatchdog, SLOTracker, TimelineStore,
                         Tracer)
from ..utils.logging import log_dist
from .metrics import ServingMetrics
from .model_group import GroupClock, RankDivergenceError, slot_rows
from .paged_pool import PagedKVPool, PagePoolExhausted
from .request import FinishReason, RejectReason, Request, RequestState
from .resilience import (DegradationConfig, FaultInjectingDrafter,
                         InvariantViolation, LoadState, LoadStateMachine,
                         ServingStalledError, select_victims)
from .scheduler import FIFOScheduler
from .slot_pool import SlotPool
from .spec_decode import SpecDecodeConfig, make_drafter

_MIN_PREFILL_BUCKET = 16

ROLES = ("both", "prefill", "decode")

# the port's counterparts of the entry points the JAX watchdog wraps
# (_WATCHED_ENGINE_JITS, _WATCHED_POOL_JITS); the paged ones exist only
# on a PagedKVPool (attach skips absentees). A captured decode or verify
# step records through DecodeGraphs.capture, on every call
_WATCHED_ENGINE = ("prefill_at", "prefill_chunk", "decode", "decode_paged",
                   "sample", "verify_k")
_WATCHED_POOL = ("admit_rows", "run_decode", "run_prefill_chunk",
                 "run_verify", "_copy_page")
# the JAX _WATCHED_SERVING_JITS' counterpart: the numerics guard
_WATCHED_SERVING = ("_finite",)
# a model drafter's engine programs (the JAX _WATCHED_DRAFTER_JITS: the
# draft model's prefill and decode run every step too)
_WATCHED_DRAFTER = ("prefill_at", "decode")

PAGED_KV_KEYS = ("num_pages", "page_size", "prefix_cache", "kernel")


def _finite_rows(logits: torch.Tensor) -> torch.Tensor:
    """(B,) bool: is every logit of row b finite. One fixed-shape call on
    the step's (num_slots, T, V) logits."""
    return torch.isfinite(logits).flatten(1).all(dim=1)


class ServingEngine:
    """Continuous-batching server over a built
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine`.

    Construct via :func:`deepspeed_tpu_torch.init_serving`. Sampling knobs
    are server-global and default to the inference config's (greedy unless
    ``do_sample``); ``max_new_tokens``, ``eos_token_id``, ``deadline_ms``,
    ``priority`` and ``tenant`` ride on each request.
    """

    def __init__(self, engine: Any, num_slots: int = 4,
                 max_queue_depth: int = 64, policy: str = "continuous",
                 do_sample: bool = False,
                 temperature: Optional[float] = None,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 seed: int = 0, monitor: Optional[Any] = None,
                 spec_decode: Any = None,
                 prefill_chunk: int = 64,
                 prefill_token_budget: Optional[int] = None,
                 tracer: Optional[Any] = None,
                 registry: Optional[Any] = None,
                 strict_recompile: bool = False,
                 timeline_capacity: int = 4096,
                 deadline_default_ms: Optional[float] = None,
                 step_wall_budget_ms: Optional[float] = None,
                 guard_numerics: bool = False,
                 degradation: Optional[Any] = None,
                 preempt_queue_threshold: Optional[int] = None,
                 preempt_min_run_steps: int = 2,
                 fault_injector: Optional[Any] = None,
                 paged_kv: Any = False,
                 slo: Any = None,
                 cost_model: Any = False,
                 flight_recorder: Any = True,
                 dump_dir: Optional[str] = None,
                 priority: Any = None,
                 clock: Optional[Callable[[], float]] = None,
                 overlap: bool = False,
                 role: str = "both"):
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        self.engine = engine
        self.mp_world_size = int(getattr(engine, "mp_world_size", 1))
        # above one model rank every rank of the world runs in lockstep
        self._group = self.mp_world_size > 1 and comm.get_world_size() > 1
        # ONE monotonic clock for every time-dependent decision: deadline
        # stamps, queue expiry, SLO latencies, degradation windows and the
        # priority scheduler's rate buckets. Injectable, so tests drive a
        # fake clock through all of them at once; over a model group, rank
        # 0's readings on every rank
        self._now = clock if clock is not None else time.perf_counter
        if self._group:
            self._now = GroupClock(self._now)
        self.device = engine.device
        spec = engine.kv_cache_spec()
        capacity = int(spec.max_seq_len)
        # chunk starts are multiples of the chunk width, so capacity %
        # chunk == 0 keeps every chunk inside the allocation; auto-halve
        # (the width is a latency knob, not a correctness contract)
        chunk = min(int(prefill_chunk), capacity)
        while chunk > 1 and capacity % chunk != 0:
            chunk //= 2
        # over (data, model): the slots this data rank's pool holds, and
        # the contiguous pool's forwards (the engine's, or those of this
        # data rank's slots with the logits assembled over the data ranks)
        shard, self._rows = slot_rows(engine, num_slots, bool(paged_kv))
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
            self.pool = SlotPool(spec, num_slots, self.device, shard=shard)
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
        sched_kw = dict(
            max_queue_depth=max_queue_depth, policy=policy,
            capacity=sched_capacity,
            page_size=self.pool.page_size if self._paged else None,
            num_pages=self.pool.num_pages if self._paged else None,
            page_headroom=self._spec.k if self._spec is not None else 0)
        # priority: None/False (plain FIFO), True (default classes), a
        # PriorityConfig kwargs dict, or an instance
        if priority:
            from .frontend.priority import PriorityScheduler
            self.scheduler = PriorityScheduler(
                num_slots, priority=priority, clock=self._now, **sched_kw)
        else:
            self.scheduler = FIFOScheduler(num_slots, **sched_kw)
        self._priority = getattr(self.scheduler, "config", None) \
            if priority else None
        # -- telemetry -------------------------------------------------
        # the tracer defaults to DISABLED: a span then costs one branch
        # and a shared null span
        if tracer is True:
            tracer = Tracer()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.step_id = 0                 # monotonic scheduler-step counter
        self.timelines = TimelineStore(capacity=timeline_capacity,
                                       tracer=self.tracer)
        self.metrics = ServingMetrics(monitor, registry=self.registry,
                                      step_fn=lambda: self.step_id)
        # slo: None/False (off), True (default SLOConfig), dict/SLOConfig
        self.slo = (SLOTracker(slo, registry=self.registry,
                               tracer=self.tracer, monitor=monitor)
                    if slo else None)
        # cost_model: False (off), True (defaults), a ProgramCostModel
        # kwargs dict, or an instance; the peaks are the engine's card's
        if cost_model is True:
            cost_model = ProgramCostModel(registry=self.registry,
                                          device=self.device)
        elif isinstance(cost_model, dict):
            cost_model = ProgramCostModel(
                **{"registry": self.registry, "device": self.device,
                   **cost_model})
        elif not cost_model:
            cost_model = None
        self.costs = cost_model
        # flight_recorder: True (defaults), int capacity, kwargs dict,
        # an instance, or False. Default ON: one deque append per step
        if flight_recorder is True:
            flight_recorder = FlightRecorder(dump_dir=dump_dir)
        elif isinstance(flight_recorder, bool):
            flight_recorder = None
        elif isinstance(flight_recorder, int):
            flight_recorder = FlightRecorder(capacity=flight_recorder,
                                             dump_dir=dump_dir)
        elif isinstance(flight_recorder, dict):
            flight_recorder = FlightRecorder(
                **{"dump_dir": dump_dir, **flight_recorder})
        elif flight_recorder is not None and dump_dir is not None \
                and flight_recorder.dump_dir is None:
            flight_recorder.dump_dir = dump_dir
        self.recorder = flight_recorder
        self.dump_dir = dump_dir
        self._tokens_emitted = 0        # lifetime tokens (all paths)
        self._tokens_prev = 0           # snapshot for per-step deltas
        self._telemetry_ns = 0          # step-boundary instrumentation
        # fleet identity: set by ReplicaRouter when the replica joins, and
        # stamped on every timeline event so journeys stitch across homes
        self.replica_id: Optional[int] = None
        # accumulated step wall: the overhead_pct denominator when no cost
        # model is attached
        self.step_wall_s = 0.0
        self.registry.add_collector(self._collect_telemetry_health)
        if self._paged:
            # pool-internal events (CoW copies, trie evictions) land in
            # the same registry as the engine-side paging/* series
            self.pool.registry = self.registry
        # -- resilience ------------------------------------------------
        if deadline_default_ms is not None and deadline_default_ms <= 0:
            raise ValueError(f"deadline_default_ms must be > 0, got "
                             f"{deadline_default_ms}")
        if step_wall_budget_ms is not None and step_wall_budget_ms <= 0:
            raise ValueError(f"step_wall_budget_ms must be > 0, got "
                             f"{step_wall_budget_ms}")
        if preempt_queue_threshold is not None and \
                preempt_queue_threshold < 1:
            raise ValueError(f"preempt_queue_threshold must be >= 1, got "
                             f"{preempt_queue_threshold}")
        self.deadline_default_ms = deadline_default_ms
        self.step_wall_budget_ms = step_wall_budget_ms
        self.preempt_queue_threshold = preempt_queue_threshold
        self.preempt_min_run_steps = int(preempt_min_run_steps)
        self._degradation = DegradationConfig.from_value(degradation)
        self._load = (LoadStateMachine(self._degradation)
                      if self._degradation is not None else None)
        self.faults = fault_injector
        drafter = self._drafter
        if self.faults is not None and self._drafter is not None:
            # surface drafter faults exactly where a real drafter throws
            self._drafter = FaultInjectingDrafter(self._drafter, self.faults)
        # the numerics guard: (num_slots,) bool of "is every logit of this
        # row finite", run on the decode logits after the step (after a
        # replay, outside the graph, so it sees what sampling sees)
        self._finite = _finite_rows if guard_numerics else None
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
        self._overlap = bool(overlap)
        # -- disaggregated prefill/decode role ---------------------------
        if role not in ROLES:
            raise ValueError(f"role must be both|prefill|decode, "
                             f"got {role!r}")
        if role != "both" and not self._paged:
            raise ValueError("prefill/decode roles require paged_kv: "
                             "pages are the cross-replica handoff unit")
        self.role = role
        # prefill role: seated RUNNING requests whose prompt is paged in
        # and first token sampled, waiting for a decode replica (they
        # hold their slot and pages until adopted)
        self._handoff_ready: Optional[List[Request]] = \
            [] if role == "prefill" else None
        self.watchdog = RecompileWatchdog(
            registry=self.registry, tracer=self.tracer, monitor=monitor,
            strict=bool(strict_recompile), step_fn=lambda: self.step_id,
            cost_model=self.costs)
        for attr in _WATCHED_ENGINE:
            self.watchdog.attach(engine, attr,
                                 name=f"InferenceEngine.{attr}")
        for attr in _WATCHED_POOL:
            self.watchdog.attach(self.pool, attr, name=f"SlotPool.{attr}")
        for attr in _WATCHED_SERVING:
            self.watchdog.attach(self, attr, name=f"ServingEngine.{attr}")
        if graphs is not None:
            # the graphs are the engine's, shared by every server on it;
            # a capture counts against the server whose pool it was
            # recorded on, as a JAX server's compiles are its own
            self.watchdog.attach(graphs, "capture",
                                 name="DecodeGraphs.capture",
                                 every_call=True, only=self._owns_capture)
        draft_engine = getattr(drafter, "engine", None)
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
        # (device tensors, callback) pairs replayed after the step's fetch
        self._deferred: List[Tuple[List[torch.Tensor], Callable]] = []
        self.fetches = 0                 # device-to-host fetches, lifetime
        self._next_id = 0
        admission = (f"stall-free chunk={self.prefill_chunk} "
                     f"budget={self.prefill_token_budget}"
                     if self._stall_free else "serial")
        storage = (f"paged page_size={self.pool.page_size} "
                   f"num_pages={self.pool.num_pages} "
                   f"prefix_cache={self.pool.prefix is not None} "
                   f"kernel={self.pool.kernel}" if self._paged
                   else "contiguous")
        log_dist(f"ServingEngine: role={role} slots={num_slots} "
                 f"policy={policy} "
                 f"capacity={self.pool.capacity} "
                 f"max_queue_depth={max_queue_depth} admission={admission} "
                 f"kv={storage} cuda_graph={graphs is not None} "
                 f"overlap={self._overlap} spec_k="
                 f"{self._spec.k if self._spec is not None else 0}",
                 ranks=[0])

    def _digest(self, phase: str, granted: Sequence[Request],
                finished: Sequence[Request]) -> int:
        """A 62-bit digest of this step's decisions so far: the granted
        request ids and the queue after the grant, or at the boundary the
        retired requests (id, reason, tokens) and every seated request's
        slot, token count and last sampled token."""
        if phase == "grant":
            value = [self.step_id, [r.request_id for r in granted],
                     self.scheduler.pending, sorted(self._slot_req)]
        else:
            value = [self.step_id,
                     [(r.request_id, getattr(r.finish_reason, "value", None),
                       len(r.output_tokens),
                       r.output_tokens[-1] if r.output_tokens else -1)
                      for r in finished],
                     sorted((slot, r.request_id, len(r.output_tokens),
                             r.output_tokens[-1] if r.output_tokens else -1)
                            for slot, r in self._slot_req.items())]
        return comm.stable_hash(value) % (2 ** 62)

    def _check_lockstep(self, phase: str, granted: Sequence[Request] = (),
                        finished: Sequence[Request] = ()) -> None:
        """Compare this step's digest across the world (no-op on one
        rank); a mismatch raises :class:`RankDivergenceError` on every
        rank."""
        if not self._group:
            return
        mine = self._digest(phase, granted, finished)
        seen = comm.all_gather_host(np.array([mine], np.int64)).reshape(-1)
        if (seen != seen[0]).any():
            err = RankDivergenceError(
                f"the model group's ranks parted at step {self.step_id} "
                f"({phase}): digests {seen.tolist()}; every rank must be "
                f"fed the same submissions in the same order")
            self._post_mortem("rank_divergence", err)
            raise err

    # ------------------------------------------------------------------
    @property
    def live_count(self) -> int:
        return len(self._slot_req)

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def _owns_capture(self, args, kwargs) -> bool:
        """Whether a ``DecodeGraphs.capture(signature, graph, cache)`` call
        recorded its graph on this server's cache (the filter of its
        watchdog's capture proxy)."""
        cache = args[2] if len(args) > 2 else kwargs.get("cache")
        return any(cache.get(name) is leaf
                   for name, leaf in self.pool.cache.items())

    def end_warmup(self) -> None:
        """Declare warmup traffic over: from here on a new signature or
        capture counts against :attr:`watchdog` ``.recompiles`` (and, with
        ``strict_recompile``, raises at the next step boundary)."""
        self.watchdog.end_warmup()

    # -- telemetry --------------------------------------------------------
    def set_tracer(self, tracer) -> None:
        """Swap the tracer in post-construction (e.g. a traced replay on
        an already-warmed server)."""
        self.tracer = tracer
        self.timelines.tracer = tracer
        self.watchdog.tracer = tracer
        if self.slo is not None:
            self.slo.tracer = tracer

    def timeline(self, request_id: int):
        """Lifecycle events recorded for one request id (oldest first),
        or None if the id is unknown/evicted."""
        return self.timelines.get(request_id)

    def publish_telemetry(self) -> int:
        """Flush the metrics registry as ``telemetry/*`` monitor events
        on the current step axis; returns the number of events."""
        return self.registry.publish(self.metrics.monitor, self.step_id)

    def _collect_telemetry_health(self) -> None:
        """Registry collector (runs at every snapshot/Prometheus scrape):
        pull-time counters that would be wasteful to push from the hot
        path: tracer ring totals and drops, sink write errors,
        flight-recorder activity."""
        g = self.registry.gauge
        g("telemetry/tracer_events_total").set(float(self.tracer.events_total))
        g("telemetry/tracer_dropped").set(float(self.tracer.dropped))
        mon = self.metrics.monitor
        jm = getattr(mon, "jsonl_monitor", None)
        if jm is None and hasattr(mon, "write_errors"):
            jm = mon          # a bare JSONL-style sink passed as the monitor
        if jm is not None:
            g("monitor/jsonl_write_errors").set(
                float(getattr(jm, "write_errors", 0)))
        if self.recorder is not None:
            g("telemetry/flight_recorder_records").set(
                float(self.recorder.records_total))
            g("telemetry/postmortem_dumps").set(
                float(self.recorder.dump_count))

    @property
    def telemetry_overhead_s(self) -> float:
        """Host seconds spent in the step-boundary instrumentation (the
        self-timed block) plus the cost model's per-call accounting and
        the SLO tracker's observe/on_step work (the cost model's one-time
        counts are warmup, in ``costs.summary()['harvest_s']``)."""
        total = self._telemetry_ns / 1e9
        if self.costs is not None:
            total += self.costs.overhead_s
        if self.slo is not None:
            total += self.slo.overhead_s
        return total

    def _telemetry_step(self, wall: float, running_at_entry: int,
                        granted: List[Request],
                        finished: List[Request]) -> None:
        """Step-boundary cost-model, SLO and flight-recorder bookkeeping,
        self-timed so its cost can be reported instead of read off noisy
        walls."""
        costs, slo, rec = self.costs, self.slo, self.recorder
        if costs is None and slo is None and rec is None:
            return
        t0 = time.perf_counter_ns()
        # the SLO tracker self-times its own methods; subtract its delta
        # from this envelope so telemetry_overhead_s never double-counts
        slo_ns0 = slo.overhead_ns if slo is not None else 0
        tokens = self._tokens_emitted - self._tokens_prev
        self._tokens_prev = self._tokens_emitted
        if slo is not None:
            if running_at_entry:
                slo.observe_gap(wall)
            slo.on_step(self.step_id)
        if costs is not None:
            costs.step_update(wall, tokens=tokens, tracer=self.tracer)
            if self.step_id % costs.kv_every == 0:
                costs.reconcile_kv(self.pool, monitor=self.metrics.monitor,
                                   step=self.step_id, tracer=self.tracer)
        if rec is not None:
            rec.record(self._step_record(wall, granted, finished))
        spent = time.perf_counter_ns() - t0
        if slo is not None:
            spent -= slo.overhead_ns - slo_ns0
        self._telemetry_ns += spent

    def _step_record(self, wall: float, granted: List[Request],
                     finished: List[Request]) -> dict:
        rec = {
            "step_id": self.step_id,
            "t_unix": time.time(),
            # the injected clock, the axis every time decision reads
            "t": self._now(),
            "replica": self.replica_id,
            "wall_ms": wall * 1e3,
            "live": len(self._slot_req),
            "pending": self.scheduler.pending,
            "prefilling": len(self._prefill_queue),
            "free_slots": self.pool.free_count,
            "granted": [r.request_id for r in granted],
            "finished": [r.request_id for r in finished],
            "tokens_total": self._tokens_emitted,
            "load_state": (self._load.state.name
                           if self._load is not None else None),
            "alert_state": (self.slo.alert_state
                            if self.slo is not None else None),
        }
        if self._paged:
            rec["free_pages"] = self.pool.free_page_count
        return rec

    def _post_mortem(self, reason: str, error: Any = None,
                     extra: Optional[dict] = None) -> Optional[str]:
        """Write a flight-recorder post-mortem dump (no-op without a
        recorder or ``dump_dir``); never raises: the caller is already
        unwinding the real failure."""
        if self.recorder is None:
            return None
        try:
            return self.recorder.dump(
                reason, error=error, timelines=self.timelines,
                registry=self.registry, tracer=self.tracer, extra=extra)
        except Exception:       # pragma: no cover - defensive
            return None

    def debug_dump(self) -> dict:
        """Live statusz snapshot: the flight-recorder ring, open request
        timelines, registry, watchdog summary, every non-terminal
        request's host state and, when enabled, the SLO summary: the
        payload a post-mortem file wraps, served from a healthy
        process."""
        rec = self.recorder if self.recorder is not None \
            else FlightRecorder(capacity=1)
        out = rec.snapshot(timelines=self.timelines,
                           registry=self.registry, tracer=self.tracer)
        out.update(step_id=self.step_id, live=self.live_count,
                   pending=self.scheduler.pending,
                   requests=self._stuck_dump(),
                   load_state=(self._load.state.name
                               if self._load is not None else None),
                   watchdog=self.watchdog.summary(),
                   telemetry_overhead_s=self.telemetry_overhead_s)
        if self.slo is not None:
            out["slo"] = self.slo.snapshot()
        if self.costs is not None:
            out["costs"] = self.costs.summary()
        return out

    def efficiency_snapshot(self) -> dict:
        """The bench-facing rollup: the cost model's MFU and bandwidth
        share, SLO goodput and latency quantiles, the KV reconciliation,
        and the instrumentation's overhead as a share of the accumulated
        step wall."""
        out: dict = {"telemetry_overhead_s": self.telemetry_overhead_s}
        wall = None
        if self.costs is not None:
            # reconcile fresh: the loop does it only every kv_every steps
            self.costs.reconcile_kv(self.pool, step=self.step_id)
            cs = self.costs.summary()
            wall = cs["wall_s"]
            out["costs"] = cs
            out["mfu"] = cs["mfu"]
            out["bandwidth_util"] = cs["bandwidth_util"]
            hbm = cs["hbm"]
            out["hbm_drift"] = hbm.get("hbm_drift")
            out["hbm_peak_bytes"] = hbm.get("hbm_peak_bytes")
        if self.slo is not None:
            ss = self.slo.snapshot()
            out["slo"] = ss
            out["goodput_slo"] = ss["goodput_slo"]
            out["ttft_p99_ms"] = ss["ttft_p99_ms"]
            out["gap_p99_ms"] = ss["gap_p99_ms"]
            out["alert_state"] = ss["alert_state"]
        if not wall:
            # no cost model: the accumulated step wall keeps overhead_pct
            # honest on SLO-only configurations
            wall = self.step_wall_s
        if wall:
            out["overhead_pct"] = 100.0 * out["telemetry_overhead_s"] / wall
        return out

    def reset_efficiency_window(self) -> None:
        """Zero the cost model's totals, the SLO windows and the overhead
        clocks (counted programs are kept): call it after warmup so the
        efficiency numbers cover only the measured run."""
        if self.costs is not None:
            self.costs.reset_totals()
        if self.slo is not None:
            self.slo.reset()
        self._telemetry_ns = 0
        self.step_wall_s = 0.0
        self._tokens_prev = self._tokens_emitted

    def _chaos_corrupt_state(self) -> None:
        """Chaos-only (the ``state_corruption`` fault point): corrupt the
        slot bookkeeping on purpose (a seated slot marked free, or a free
        slot dropped) so ``check_invariants`` and the flight recorder
        behind it face real corruption. Reachable only through an armed
        FaultInjector."""
        if self._slot_req:
            self.pool._free_set.add(min(self._slot_req))
        elif self.pool._free_set:
            self.pool._free_set.discard(min(self.pool._free_set))
        self.tracer.instant("chaos/state_corruption")

    # -- submission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               priority: Optional[str] = None,
               tenant: Optional[str] = None) -> Request:
        """Enqueue one generation request. Never raises on load: admission
        control marks the returned request ``REJECTED`` with a
        ``reject_reason`` (``"queue_full"``, ``"prompt_too_long"``,
        ``"rate_limited"``/``"tenant_quota"`` under tenant policies, or
        ``"retry_after"`` when overload or burn-rate shedding is active,
        with ``req.retry_after_s`` the backoff hint).

        ``priority``/``tenant`` (priority scheduling only) pick the
        request's class and rate-limit bucket; an unknown class raises
        ``ValueError``. While a class's SLO burn alert is at warn/page,
        submissions of strictly lower classes are shed with
        ``retry_after``.

        ``deadline_ms`` (or the engine-wide ``deadline_default_ms``) arms
        a TTL from submission: a request that cannot finish in time
        retires with ``finish_reason="deadline"``, out of the queue before
        it costs a prefill, or out of its slot."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = Request(self._next_id, prompt, max_new_tokens, eos_token_id)
        self._next_id += 1
        if self._priority is not None:
            req.priority_class = (priority if priority is not None
                                  else self._priority.default_class)
            self.scheduler.rank_of(req.priority_class)  # loud on unknown
        elif priority is not None:
            raise ValueError("priority classes require a priority-enabled "
                             "engine (pass priority=True/config to "
                             "ServingEngine / init_serving)")
        if tenant is not None:
            req.tenant = str(tenant)
        req.submit_time = self._now()
        ttl = deadline_ms if deadline_ms is not None \
            else self.deadline_default_ms
        if ttl is not None:
            if ttl <= 0:
                raise ValueError(f"deadline_ms must be > 0, got {ttl}")
            req.deadline_ms = float(ttl)
            req.deadline_time = req.submit_time + float(ttl) / 1e3
        if self._load is not None and self._load.state is LoadState.OVERLOADED:
            # overload shedding: stop feeding the queue before it melts
            accepted, reason = False, RejectReason.RETRY_AFTER
            req.retry_after_s = self._degradation.retry_after_s
        elif self._shed_by_burn(req):
            accepted, reason = False, RejectReason.RETRY_AFTER
            if req.retry_after_s is None:
                req.retry_after_s = (
                    self._degradation.retry_after_s
                    if self._degradation is not None else 1.0)
        else:
            accepted, reason = self.scheduler.submit(req)
        self.timelines.record(req.request_id, "submitted",
                              prompt_len=req.prompt_len,
                              max_new_tokens=max_new_tokens,
                              priority_class=req.priority_class,
                              tenant=req.tenant)
        if not accepted:
            req.state = RequestState.REJECTED
            req.reject_reason = reason
            self.metrics.record_rejection(req)
            self.timelines.record(req.request_id, "rejected", terminal=True,
                                  reason=reason.value,
                                  retry_after_s=req.retry_after_s)
        elif self.slo is not None:
            # goodput denominator: every ADMITTED request counts against
            # the window, whether or not it ever finishes in time
            self.slo.observe_admitted(cls=req.priority_class)
        return req

    def _shed_floor(self) -> Optional[int]:
        """The lowest class rank still admitted under burn-rate shedding,
        or None when nothing is burning (or priority/SLO tracking is off).
        When class ``k``'s burn alert is warn/page, every class ranked
        strictly below ``k`` is shed."""
        if self._priority is None or self.slo is None:
            return None
        floor = None
        for cls, alert in self.slo.class_alerts.items():
            if alert in ("warn", "page"):
                try:
                    k = self.scheduler.rank_of(cls)
                except ValueError:
                    continue  # SLO classes need not all be sched classes
                floor = k if floor is None else min(floor, k)
        return floor

    def _shed_by_burn(self, req: Request) -> bool:
        floor = self._shed_floor()
        return floor is not None \
            and self.scheduler.rank_of(req.priority_class) > floor

    # ------------------------------------------------------------------
    def _sample(self, logits) -> torch.Tensor:
        return self.engine.sample(logits, self._gen, self.temperature,
                                  self.top_k, self.top_p, self._greedy)

    def _defer(self, tensors: Sequence[torch.Tensor],
               callback: Callable) -> None:
        """Run ``callback(*host_values)`` after the step's one fetch: each
        device tensor comes back as a (nested) list of Python numbers."""
        self._deferred.append((list(tensors), callback))

    def _drain_deferred(self) -> None:
        """The step's one device-to-host fetch: every deferred tensor is
        flattened into one int64 vector on the device and copied back at
        once, then the queued bookkeeping replays in dispatch order. The
        wait is observed into the ``timer/serving/step_fetch_ms``
        histogram."""
        if not self._deferred:
            return
        pending, self._deferred = self._deferred, []
        tensors = [t for arrays, _ in pending for t in arrays]
        t0 = time.perf_counter()
        flat = [t.reshape(-1).long() for t in tensors]
        host = (flat[0] if len(flat) == 1 else torch.cat(flat)).cpu().numpy()
        self.fetches += 1
        self.registry.histogram("timer/serving/step_fetch_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        at = 0
        for arrays, callback in pending:
            values = []
            for t in arrays:
                n = t.numel()
                values.append(host[at:at + n].reshape(t.shape).tolist())
                at += n
            callback(*values)

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
        first = req.first_token_time is None
        if first:
            req.first_token_time = self._now()
        req.output_tokens.append(token)
        self._tokens_emitted += 1
        if first:
            self.timelines.record(req.request_id, "first_token")
        self._maybe_retire(req, token, finished)

    # -- admission -------------------------------------------------------
    def _admit_batch(self, group: List[Request], width: int,
                     finished: List[Request]) -> None:
        """Whole-seed admission of ``group`` (same bucket ``width``) in one
        ``prefill_at`` call projecting each seed's true last position, the
        K/V going straight into the slots (contiguous rows, or pages
        through :meth:`PagedKVPool.admit_rows`). A group of one is the JAX
        engine's per-request admission (span ``serving/admit``, timeline
        mode ``bucketed``), a larger one its batched admission
        (``serving/prefill_batch``, ``batched``). Rolls the whole group
        back to clean QUEUED requests on an exception."""
        n = len(group)
        single = n == 1
        ids = np.zeros((n, width), np.int64)
        last_pos = np.zeros((n,), np.int64)
        lengths = np.zeros((n,), np.int64)
        slots: List[int] = []
        running_before = self._running_count()
        # rollback snapshots: a preempted request keeps its tokens/stamps
        n0s = [len(r.output_tokens) for r in group]
        stamps = [(r.admit_time, r.first_token_time) for r in group]
        try:
            if self.faults is not None:
                self.faults.check("admit_oom")
            for i, req in enumerate(group):
                T = req.seed_len
                ids[i, :T] = req.seed_tokens
                last_pos[i] = T - 1
                lengths[i] = T
                req.admit_time = self._now()
                slots.append(self.pool.alloc())
            t0 = self._now()
            span = (self.tracer.span("serving/admit",
                                     rid=group[0].request_id,
                                     tokens=int(lengths[0]), width=width)
                    if single else
                    self.tracer.span("serving/prefill_batch", n=n,
                                     width=width, batch=n))
            with span:
                cache, rows = self.pool.prefill_target(slots, width)
                logits, _ = self._rows.prefill_at(
                    torch.as_tensor(ids, device=self.device), last_pos,
                    cache=cache, rows=rows)
                self.pool.admit_rows(cache, slots, lengths)
                with self.tracer.span("serving/sample"):
                    tok = self._sample(logits)
                self._cur[torch.as_tensor(slots, device=self.device)] = tok
            self.metrics.record_prefill(int(lengths.sum()), self._now() - t0,
                                        blocking=running_before > 0)
            for req, slot in zip(group, slots):
                self._seat(req, slot, RequestState.RUNNING)
                self.timelines.record(req.request_id, "admitted", slot=slot,
                                      mode="bucketed" if single
                                      else "batched")
                self.tracer.flow("s", "req", req.request_id)
                if self._use_prefix:
                    self.pool.cache_prefix(slot, req.seed_tokens)

            def _on_tokens(tok, group=group):
                for req, token in zip(group, tok):
                    self._emit_first(req, int(token), finished)

            self._defer([tok], _on_tokens)
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
        lowest-class, youngest OTHER seated request, whose pages return to
        the free list, and retry. Only with no victim left does the
        exhaustion propagate (one request's footprint exceeding the whole
        pool, which the submit-time page check rejects)."""
        while True:
            try:
                self.pool.ensure_writable(slot, start, end)
                return
            except PagePoolExhausted:
                victims = [r for r in select_victims(
                    list(self._slot_req.values()), n=len(self._slot_req),
                    current_step=self.step_id, min_run_steps=0,
                    class_rank=self._class_rank)
                    if r.slot != slot]
                if not victims:
                    raise
                self._preempt_req(victims[0], auto=True)

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
            if self.faults is not None:
                self.faults.check("admit_oom")
            pool.reset_row(slot)
            pool.seat_prefix(slot, pages, pos0)
        except PagePoolExhausted:
            # the uncached suffix needs more fresh pages than remain:
            # release (unmapping anything seated so far) and retry next
            # step, once eviction or preemption has freed pages
            pool.release(slot)
            self.scheduler.requeue_front([req])
            self.timelines.record(req.request_id, "requeued",
                                  reason="page_pressure")
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
        self.timelines.record(req.request_id, "admitted", slot=slot,
                              mode="prefix_hit")
        self.timelines.record(req.request_id, "prefix_hit",
                              hit_tokens=pos0, seed_len=seed_len)
        self.tracer.flow("s", "req", req.request_id)
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
                self.timelines.record(req.request_id, "admitted", slot=slot,
                                      mode="chunked")
                self.tracer.flow("s", "req", req.request_id)
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
        with self.tracer.span("serving/prefill_chunk", rid=req.request_id,
                              pos=pos, len=L):
            if self._paged:
                logits = self.pool.run_prefill_chunk(self.engine, ids, slot,
                                                     pos, L - 1)
            else:
                logits = self._rows.prefill_chunk(self.pool.cache, ids,
                                                  slot, pos, L - 1)
        self.pool.starts[slot] = pos + L
        req.prefill_pos = pos + L
        req.chunks += 1
        self.timelines.record(req.request_id, "prefill_chunk", pos=pos,
                              len=L)
        self.metrics.record_prefill(L, self._now() - t0,
                                    blocking=running_before > 0)
        if req.prefill_pos < seed_len:
            return
        with self.tracer.span("serving/sample"):
            tok = self._sample(logits)
        self._cur[slot] = tok[0]
        self._prefill_queue.pop(0)
        req.state = RequestState.RUNNING
        req.last_admit_step = self.step_id
        if self._use_prefix:
            self.pool.cache_prefix(slot, seed)
        self._defer([tok], lambda tok, req=req: self._emit_first(
            req, int(tok[0]), finished))

    # -- decode and retirement -----------------------------------------
    def _guard_rows(self, finite, running):
        """Replay half of the NaN/inf guard: given the fetched per-row
        finiteness, return the survivors of ``running`` and fail the
        poisoned rows. Runs inside the drain: the flags rode the step's
        one fetch beside the tokens."""
        if finite is None:
            return running
        if self._group:
            # a row poisoned on any rank fails on every rank
            finite = comm.all_reduce_host(
                np.asarray(finite, np.int64), op=comm.ReduceOp.MIN)
        ok = [(slot, req) for slot, req in running if finite[slot]]
        for slot, req in running:
            if not finite[slot] and req.state is RequestState.RUNNING:
                self._fail_slot(req, FinishReason.NUMERICAL_ERROR)
        return ok

    def _positions_dev(self) -> torch.Tensor:
        """The pool's decode positions on the device; the cost model gets
        their host copy, the live lengths the step's attention reads."""
        if self.costs is not None:
            lo, hi = self.pool.shard
            self.costs.positions = self.pool.positions()[lo:hi]
        return self.pool.positions_dev()

    def _decode_step(self, finished: List[Request], t0: float) -> None:
        if self._paged:
            # page the write position in BEFORE snapshotting the running
            # set: under pressure this can preempt a victim out of it
            self._ensure_decode_pages(1)
        running = [(slot, req) for slot, req in self._slot_req.items()
                   if req.state is RequestState.RUNNING]
        pos = self._positions_dev()
        tokens = self._cur[:, None]
        with self.tracer.span("serving/decode", live=len(running)):
            if self._paged:
                logits = self.pool.run_decode(self.engine, tokens, pos)
            else:
                logits = self._rows.decode(self.pool.cache, tokens, pos)
        if self.faults is not None:
            # in place, on the device: a captured step's next replay
            # rewrites its output, so the poison never outlives this step
            logits, _ = self.faults.corrupt_logits(
                logits, [slot for slot, _ in running])
        # the finite check runs on what sampling sees; its (B,) flags
        # ride the step's one fetch
        finite = (self._finite(logits)
                  if self._finite is not None and running else None)
        # only running rows grew; PREFILLING rows rode along as masked
        # padding and keep their chunk offsets
        deltas = np.zeros((self.pool.num_slots,), np.int32)
        deltas[[slot for slot, _ in running]] = 1
        self.pool.advance(deltas)
        with self.tracer.span("serving/sample"):
            nxt = self._sample(logits)
        # every row's next current token is this decode's sample for it
        # (other rows hold values no live row ever reads); in place, so
        # the token vector keeps its address
        self._cur.copy_(nxt)

        def _on_decode(nxt, finite=None, running=running):
            live = self._guard_rows(finite, running)
            emitted = 0
            for slot, req in live:
                if req.state is not RequestState.RUNNING:
                    # retired (or preempted) earlier in this step: its
                    # decode row was padding, and its token is dropped
                    continue
                token = int(nxt[slot])
                req.output_tokens.append(token)
                emitted += 1
                self._maybe_retire(req, token, finished)
            self._tokens_emitted += emitted
            self.metrics.record_decode_step(emitted, len(running),
                                            step_s=self._now() - t0)

        self._defer([nxt] if finite is None else [nxt, finite], _on_decode)

    def _spec_decode_step(self, finished: List[Request], t0: float) -> None:
        """Draft K tokens per running slot, verify them all in ONE
        fixed-shape (num_slots, K+1) forward, keep each slot's accepted
        prefix + bonus token, and roll back the rejected positions through
        the per-slot lengths. Under OVERLOADED, drafting is suspended:
        zero-length drafts go through the same verify forward (and its
        captured graph), a plain decode step per row."""
        K = self._spec.k
        B = self.pool.num_slots
        if self._paged:
            # verify writes K+1 columns past every RUNNING slot's length:
            # page them in first (under pressure this may preempt, so
            # before the drafter snapshots the live set)
            self._ensure_decode_pages(K + 1)
        if self._load is not None and \
                self._load.state is LoadState.OVERLOADED:
            # no shape changes: the same verify, draft_len 0 in every row
            draft = np.zeros((B, K), np.int64)
            draft_len = np.zeros((B,), np.int64)
            t_draft = 0.0
        else:
            if self._deferred:
                # admissions sampled first tokens earlier in THIS step (the
                # serial order): the drafter's host histories need them,
                # so settle them now. Steady decode steps, and overlap
                # mode, which verifies before admitting, keep one fetch
                self._drain_deferred()
            # PREFILLING and free slots keep histories None: draft_len 0,
            # and their deltas stay 0 below, so verify's writes roll back
            histories: List[Optional[np.ndarray]] = [None] * B
            for slot, req in self._slot_req.items():
                if req.state is RequestState.RUNNING:
                    histories[slot] = req.tokens()
            with self.tracer.span("serving/draft", k=K):
                draft, draft_len = self._drafter.propose(histories, K)
            draft = np.asarray(draft, np.int64)
            draft_len = np.clip(np.asarray(draft_len, np.int64), 0, K)
            t_draft = self._now() - t0
        # stream-ordered uploads into static buffers: no host sync
        copy_from_host(self._draft, draft)
        copy_from_host(self._draft_len, draft_len)
        tokens = torch.cat([self._cur[:, None], self._draft], dim=1)
        args = (tokens, self._positions_dev(), self._draft,
                self._draft_len, self._gen, self.temperature, self._greedy,
                self.top_k, self.top_p)
        with self.tracer.span("serving/verify_k", k=K):
            if self._paged:
                out, n_emit = self.pool.run_verify(self.engine, *args)
            else:
                out, n_emit = self._rows.verify_k(self.pool.cache, *args)
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
            self._tokens_emitted += emitted
            self.metrics.record_decode_step(
                emitted, len(live), drafted=drafted, accepted=accepted,
                draft_s=t_draft, step_s=self._now() - t0)

        # one fetch: the emitted tokens with their counts in a last column
        self._defer([torch.cat([out, n_emit[:, None]], dim=1)], _on_verify)

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
            if self._handoff_ready is not None and \
                    req.state is RequestState.RUNNING:
                # prefill role: pages full, first token sampled; the
                # request now belongs to a decode replica. It stays seated
                # (slot and page references held) until the router moves
                # it or a rollback path retires it
                self._handoff_ready.append(req)
                # parked: the journey probe must not count the prefill
                # side as done although its timeline is still open
                self.timelines.record(req.request_id, "handoff_ready",
                                      parked=True, slot=req.slot,
                                      journey=req.journey_id)
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
        self._finish_record(req)
        finished.append(req)

    def _finish_record(self, req: Request) -> None:
        """Shared terminal bookkeeping for every FINISHED retirement
        (normal, length-capped, deadline-expired or cancelled): metrics,
        the SLO verdict, the flow arrow and the terminal timeline
        event."""
        self.metrics.record_finish(req)
        if self.slo is not None:
            if req.finish_reason is FinishReason.CANCELLED:
                # a client cancellation is neither good nor bad service:
                # withdraw the admission instead of judging latencies
                self.slo.observe_cancel(cls=req.priority_class)
            else:
                ok = req.finish_reason in (FinishReason.EOS,
                                           FinishReason.LENGTH,
                                           FinishReason.LENGTH_CAP)
                e2e = (req.finish_time - req.submit_time
                       if req.finish_time is not None and
                       req.submit_time is not None else None)
                self.slo.observe_finish(ttft_s=req.ttft,
                                        per_token_s=req.per_token_latency,
                                        e2e_s=e2e, ok=ok,
                                        cls=req.priority_class)
        self.tracer.flow("f", "req", req.request_id)
        self.timelines.record(req.request_id, "finished", terminal=True,
                              reason=FinishReason.of(req.finish_reason).value,
                              new_tokens=len(req.output_tokens),
                              chunks=req.chunks,
                              spec_drafted=req.spec_drafted,
                              spec_accepted=req.spec_accepted)

    # -- disaggregated prefill/decode handoff --------------------------
    def pending_handoffs(self) -> List[Request]:
        """Prefill role: the seated RUNNING requests whose prefill is done
        and first token sampled, ready for a decode replica. Reading it
        changes nothing: a successful :meth:`adopt` on the destination and
        :meth:`finish_handoff` here remove an entry, so a request the
        router cannot place this step is retried at the next."""
        return list(self._handoff_ready or ())

    def adopt(self, req: Request, src: "ServingEngine") -> dict:
        """Seat a request whose prefill ran on ANOTHER replica: copy its
        live pages across pools (:meth:`PagedKVPool.import_pages`), seat
        them, and resume the decode at the source's position. Pages this
        pool's prefix trie already holds for the written part of the
        request's tokens are mapped instead (a refcount bump) and only the
        tail is moved. The moved pages are the bits the source wrote, and
        the first token was sampled from them, so greedy output is the
        colocated engine's.

        On any failure nothing stays seated here (the imported pages and
        the slot are handed back) and the exception propagates; the
        request is still seated on the source. Returns ``{"pages",
        "hit_pages", "bytes", "seconds"}`` (host seconds: the copies are
        issued, not waited for)."""
        if self.role == "prefill":
            raise ValueError("adopt() needs a decode-capable replica "
                             "(role 'decode' or 'both')")
        if not self._paged or not getattr(src, "_paged", False):
            raise ValueError("adopt() requires paged KV on both replicas")
        if req.state is not RequestState.RUNNING or req.slot is None:
            raise ValueError(f"adopt() needs a seated RUNNING request; "
                             f"req {req.request_id} is {req.state.value}")
        pool, spool = self.pool, src.pool
        src_slot = req.slot
        pos = int(spool.starts[src_slot])
        # the tokens whose K/V the pages hold: the last sampled one is
        # written by the next decode step, so its page is not a trie page
        # yet (it would be published with that position unwritten)
        written = req.seed_tokens[:pos]
        n_live = -(-pos // spool.page_size)
        src_pages = [int(p) for p in spool.table[src_slot, :n_live]]
        t0 = self._now()
        slot = pool.alloc()
        hit_pages: List[int] = []
        try:
            pool.reset_row(slot)
            if self._use_prefix:
                hit_pages = pool.prefix.match(written)[:n_live]
            if hit_pages:
                pool.map_prefix(slot, hit_pages)
            dst_pages = pool.import_pages(spool, src_pages[len(hit_pages):])
        except Exception:
            # import_pages unwound its own pages: only the slot (and any
            # mapped prefix pages) is left to release
            pool.release(slot)
            raise
        try:
            pool.seat_pages(slot, dst_pages, pos, first_entry=len(hit_pages))
        except Exception:
            # seat_pages is atomic: it took none of the batch
            pool.unref_pages(dst_pages)
            pool.release(slot)
            raise
        now = self._now()
        req.slot = slot
        req.last_admit_step = self.step_id
        if req.admit_time is None:
            req.admit_time = now
        self._slot_req[slot] = req
        # the source's last sampled token resumes the decode here; in
        # place, so a captured step keeps reading the same vector. A step
        # ends with its fetch (overlap too), so no deferred sample of an
        # earlier step can overwrite this row afterwards
        self._cur[slot] = int(req.output_tokens[-1])
        if self._use_prefix:
            # publish the adopted prompt's full pages in THIS trie: the
            # next same-prefix handoff routed here moves only its tail
            pool.cache_prefix(slot, written)
        self.timelines.record(req.request_id, "adopted", slot=slot,
                              pages=len(dst_pages),
                              hit_pages=len(hit_pages),
                              src_replica=src.replica_id,
                              dst_replica=self.replica_id,
                              journey=req.journey_id)
        self.tracer.flow("s", "req", req.request_id)
        return {"pages": len(dst_pages), "hit_pages": len(hit_pages),
                "bytes": len(dst_pages) * pool.page_nbytes,
                "seconds": now - t0}

    def finish_handoff(self, req: Request, slot: int,
                       dst_replica: Optional[int] = None) -> None:
        """Prefill role: release the source seat AFTER a decode replica
        adopted the request. ``slot`` is the source slot (``req.slot``
        already names the destination's). The slot and its page references
        go back through the usual release (trie-cached prompt pages stay
        warm for the next same-prefix prompt), and the request's timeline
        here closes with a terminal ``handed_off`` event (it finishes on
        the adopting replica's timeline)."""
        if self._slot_req.get(slot) is not req:
            raise ValueError(f"finish_handoff: slot {slot} does not seat "
                             f"req {req.request_id}")
        del self._slot_req[slot]
        self.pool.release(slot)
        if self._handoff_ready:
            self._handoff_ready[:] = [r for r in self._handoff_ready
                                      if r is not req]
        self.timelines.record(req.request_id, "handed_off", terminal=True,
                              slot=slot, src_replica=self.replica_id,
                              dst_replica=dst_replica,
                              journey=req.journey_id)

    # -- resilience: eviction, deadlines, preemption -------------------
    def _evict_slot(self, req: Request) -> None:
        """Reclaim a seated request's slot and pages: release the slot
        (its stale rows become masked padding) and detach all seat state.
        The caller decides what the request becomes next (FINISHED on
        deadline or cancel, QUEUED on preemption, FAILED on poisoned
        logits)."""
        slot = req.slot
        del self._slot_req[slot]
        self.pool.release(slot)
        req.slot = None
        # identity filter: value equality would compare numpy prompts
        self._prefill_queue[:] = [r for r in self._prefill_queue
                                  if r is not req]
        if self._handoff_ready:
            # a parked handoff that retires (deadline, cancel, preemption)
            # before a decode replica adopts it leaves the launchpad
            self._handoff_ready[:] = [r for r in self._handoff_ready
                                      if r is not req]

    def _expire_deadlines(self, finished: List[Request]) -> None:
        """Retire every request whose deadline has passed: queued ones
        before they cost a prefill, seated ones through slot eviction. At
        the step boundary, so an expiry never interleaves a dispatch."""
        now = self._now()
        expired = self.scheduler.expire(now)
        for slot, req in list(self._slot_req.items()):
            if req.expired(now):
                self._evict_slot(req)
                expired.append(req)
        for req in expired:
            req.state = RequestState.FINISHED
            req.finish_reason = FinishReason.DEADLINE
            req.finish_time = now
            self._finish_record(req)
            finished.append(req)

    def preempt(self, request_id: int) -> Request:
        """Evict a seated (RUNNING or PREFILLING) request and re-queue it
        at the FRONT of the admission queue with its generated tokens; its
        next admission prefills prompt + outputs through the same
        bucketed/chunked paths, and its greedy output is unchanged. Raises
        ``ValueError`` if the id is not currently seated."""
        for req in self._slot_req.values():
            if req.request_id == request_id:
                self._preempt_req(req, auto=False)
                return req
        raise ValueError(f"request {request_id} is not seated in a slot "
                         f"(only RUNNING/PREFILLING requests can be "
                         f"preempted)")

    def cancel(self, request_id: int) -> Optional[Request]:
        """Cancel a request by id (the client hung up). A QUEUED request
        leaves the queue before it costs a prefill; a seated one is
        evicted (slot released, pages unreferenced) and not re-queued.
        Either way it retires ``FINISHED``/``cancelled`` with a terminal
        timeline event, and the SLO accounting withdraws its admission.
        Returns the request, or None when the id is unknown or already
        terminal (a cancel racing the final token is normal)."""
        for r in self.scheduler.queue:
            if r.request_id == request_id:
                self.scheduler.queue = type(self.scheduler.queue)(
                    x for x in self.scheduler.queue if x is not r)
                return self._finish_cancel(r)
        for r in list(self._slot_req.values()):
            if r.request_id == request_id:
                slot = r.slot
                self._evict_slot(r)
                self.tracer.instant("serving/cancel", rid=r.request_id,
                                    slot=slot)
                return self._finish_cancel(r)
        return None

    def _finish_cancel(self, req: Request) -> Request:
        req.state = RequestState.FINISHED
        req.finish_reason = FinishReason.CANCELLED
        req.finish_time = self._now()
        self._finish_record(req)
        return req

    def _preempt_req(self, req: Request, auto: bool = True) -> None:
        """Evict ``req`` back to the queue with its generated tokens: at
        the TAIL for an automatic (pressure) victim, whose re-queue at the
        head would hand it its own slot back at the next grant, forever;
        at the head for a manual :meth:`preempt`."""
        slot = req.slot
        self._evict_slot(req)
        req.state = RequestState.QUEUED
        req.prefill_pos = 0       # a partial chunked prefill restarts
        req.admit_time = None
        req.preemptions += 1
        if auto:
            self.scheduler.requeue_back([req])
        else:
            self.scheduler.requeue_front([req])
        self.metrics.record_preemption(req)
        self.timelines.record(req.request_id, "preempted", slot=slot,
                              auto=auto, generated=len(req.output_tokens))
        self.tracer.instant("serving/preempt", rid=req.request_id,
                            slot=slot, auto=auto)

    def _auto_preempt(self) -> None:
        """Pressure valve: when the queue has outgrown the threshold and
        every slot is taken (or, paged, the queue head's fresh pages
        exceed what the pool could free without a preemption), evict ONE
        victim per step (lowest class, youngest / least progress first;
        seated at least ``preempt_min_run_steps``)."""
        if (self.preempt_queue_threshold is None
                or self.scheduler.pending <= self.preempt_queue_threshold):
            return
        starved = self.pool.free_count == 0
        head = self.scheduler.head()
        if not starved and self._paged and head is not None:
            starved = self._page_cost(head) > self._grant_page_budget()
        if not starved:
            return
        victims = select_victims(
            list(self._slot_req.values()), n=1, current_step=self.step_id,
            min_run_steps=self.preempt_min_run_steps,
            class_rank=self._class_rank)
        for req in victims:
            self._preempt_req(req, auto=True)

    def _class_rank(self, req: Request) -> int:
        """Victim-selection key: a request's priority rank (0 = highest)
        under priority scheduling, 0 for everyone under plain FIFO."""
        if self._priority is None:
            return 0
        return self.scheduler.rank_of(req.priority_class)

    def _burn_preempt(self) -> None:
        """Burn-rate-driven preemption, the seated half of class shedding:
        while a class's burn alert is at warn/page, if a protected-class
        request waits and the pool is starved, one resident of a strictly
        lower class is evicted per step (tail re-queued, so it resumes
        once the burn clears)."""
        floor = self._shed_floor()
        if floor is None:
            return
        head = self.scheduler.head_within(floor)
        if head is None:
            return  # nobody protected is waiting
        starved = self.pool.free_count == 0
        if not starved and self._paged:
            starved = self._page_cost(head) > self._grant_page_budget()
        if not starved:
            return  # normal admission will seat the protected head
        sheddable = [r for r in self._slot_req.values()
                     if self._class_rank(r) > floor]
        victims = select_victims(
            sheddable, n=1, current_step=self.step_id,
            min_run_steps=self.preempt_min_run_steps,
            class_rank=self._class_rank)
        for req in victims:
            self._preempt_req(req, auto=True)

    def _effective_prefill_budget(self) -> Optional[int]:
        """The step's prefill token budget after degradation: PRESSURED
        halves it (floor: one chunk), OVERLOADED pins it at one chunk;
        the chunk width never changes."""
        budget = self.prefill_token_budget
        if budget is None or self._load is None:
            return budget
        if self._load.state is LoadState.OVERLOADED:
            return max(self.prefill_chunk, 1)
        if self._load.state is LoadState.PRESSURED:
            return max(self.prefill_chunk, budget // 2)
        return budget

    def _update_load_state(self) -> None:
        if self._load is None:
            return
        cfg = self._degradation
        gaps = self.metrics.step_gaps[-cfg.window:]
        p99 = float(np.percentile(np.asarray(gaps), 99) * 1e3) \
            if gaps else None
        pending = self.scheduler.pending
        head = self.scheduler.head()
        if self._paged and head is not None and \
                self._page_cost(head) > self._grant_page_budget():
            # page starvation is load even when the queue is short
            pending = max(pending, cfg.queue_pressured)
        moved = self._load.update(pending, p99, step=self.step_id)
        self.tracer.counter("serving/load_state",
                            level=int(self._load.state))
        if moved is not None:
            old, new = moved
            self.metrics.record_load_state(old, new)
            self.tracer.instant("serving/load_transition", old=old.name,
                                new=new.name, queue=self.scheduler.pending,
                                gap_p99_ms=p99)
            log_dist(f"ServingEngine: load {old.name} -> {new.name} "
                     f"(queue={self.scheduler.pending}, "
                     f"gap_p99_ms={p99})", ranks=[0])

    def _fail_slot(self, req: Request, reason: FinishReason) -> None:
        """Fail ONE seated request (poisoned logits): evict its slot and
        mark it FAILED, leaving every other slot's tokens from the same
        step untouched."""
        self._evict_slot(req)
        req.state = RequestState.FAILED
        req.finish_reason = reason
        req.finish_time = self._now()
        self.metrics.record_failure(req)
        self.tracer.flow("f", "req", req.request_id)
        self.timelines.record(req.request_id, "failed", terminal=True,
                              reason=reason.value,
                              new_tokens=len(req.output_tokens))

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One scheduler iteration: expire deadlines, walk the load
        ladder, preempt under pressure, admit into free slots, run at most
        one prefill chunk, then one decode step for every running slot
        (with ``overlap``: the decode for the slots running at entry
        first, then admission and the chunk; slots admitted this step join
        the decode next step). Returns the requests that finished.

        Exception-safe: if the engine raises mid-step, no slot or page
        leaks. Granted-but-unadmitted and PREFILLING requests go back to
        the head of the queue, running ones are FAILED (reason
        ``"error"``), the pool is reset, and the error propagates. The
        strict recompile check runs after the step, at its boundary, and
        fails no request."""
        finished: List[Request] = []
        self.step_id += 1
        tracer = self.tracer
        t_step = self._now()
        running_at_entry = self._running_count()
        with tracer.span("serving/step", step=self.step_id):
            # boundary work first, outside the abort scope: it touches no
            # device state, so a failure here must not FAIL anyone
            self._expire_deadlines(finished)
            self._update_load_state()
            self._auto_preempt()
            self._burn_preempt()
            tracer.counter("serving/occupancy", live=self.live_count,
                           pending=self.scheduler.pending)
            with tracer.span("serving/grant"):
                page_budget = self._grant_page_budget() if self._paged \
                    else None
                page_cost = self._page_cost if self._paged else None
                if self._stall_free:
                    # one chunk for the prefill-queue head runs this step:
                    # charge it up front so admissions + chunk stay within
                    # the budget
                    granted = self.scheduler.grant(
                        self.pool.free_count, self.live_count,
                        token_budget=self._effective_prefill_budget(),
                        cost=self._admission_cost,
                        spent=self.prefill_chunk if self._prefill_queue
                        else 0,
                        page_budget=page_budget, page_cost=page_cost)
                else:
                    granted = self.scheduler.grant(
                        self.pool.free_count, self.live_count,
                        page_budget=page_budget, page_cost=page_cost)
            try:
                self._check_lockstep("grant", granted)
                decode = (self._spec_decode_step if self._spec is not None
                          else self._decode_step)
                decoded = False
                # a prefill replica never decodes: its finished prefills
                # wait, seated, for the router's handoff
                decodes = self.role != "prefill"
                if self._overlap and decodes and self._running_count():
                    # pipelined order: the running slots' decode (or draft
                    # + verify) is issued first, so admission's host work
                    # overlaps it on the card
                    decode(finished, self._now())
                    decoded = True
                if self._stall_free:
                    self._admit_stall_free(granted, finished)
                    self._prefill_chunk_step(finished)
                else:
                    for req in granted:
                        self._admit_batch(
                            [req],
                            self._bucket(req.seed_len, self.pool.capacity),
                            finished)
                if self.faults is not None:
                    # between admission and decode: requests are seated
                    # (the abort path's worst case) but no decode state
                    # has moved yet
                    self.faults.maybe_sleep("slow_dispatch")
                    self.faults.check("step_host_error")
                if not decoded and decodes and self._running_count():
                    decode(finished, self._now())
                # the step's ONE fetch: every deferred token and flag at
                # once, then the host bookkeeping in dispatch order
                self._drain_deferred()
            except Exception:
                self._abort_step(granted)
                raise
        if self._paged:
            # per-step paging gauges: occupancy and sharing of the pool
            free = self.pool.free_page_count
            shared = int(np.sum(self.pool.page_refs > 1))
            self.registry.gauge("paging/free_pages").set(float(free))
            self.registry.gauge("paging/pages_in_use").set(
                float(self.pool.num_pages - free))
            self.registry.gauge("paging/refcounted_pages").set(float(shared))
            tracer.counter("paging/pages", free=free,
                           in_use=self.pool.num_pages - free, shared=shared)
        if self.faults is not None and self.faults.fires("state_corruption"):
            # chaos: corrupt our own slot bookkeeping at the boundary so
            # check_invariants and the flight recorder face REAL damage
            self._chaos_corrupt_state()
        self._check_lockstep("step", finished=finished)
        wall = self._now() - t_step
        self.step_wall_s += wall
        self._telemetry_step(wall, running_at_entry, granted, finished)
        # the strict recompile gate sits at the step boundary: raising
        # mid-step would abort the step and FAIL requests whose state is
        # consistent
        try:
            self.watchdog.check()
        except RecompileAfterWarmupError as e:
            self._post_mortem("recompile_after_warmup", e)
            raise
        if self.step_wall_budget_ms is not None and \
                wall * 1e3 > self.step_wall_budget_ms:
            # per-step wall-time watchdog: flag, don't kill
            self.metrics.record_step_overrun(wall, self.step_wall_budget_ms)
            tracer.instant("serving/step_overrun", wall_ms=wall * 1e3,
                           budget_ms=self.step_wall_budget_ms)
        if running_at_entry:
            # a running request waited through this whole step for its
            # next token: the user-visible inter-token gap
            self.metrics.record_step_gap(wall)
        return finished

    def _abort_step(self, granted: List[Request]) -> None:
        """Mid-step exception recovery: never leak a slot or a page.
        Requests the failed admission rolled back re-join the queue head;
        PREFILLING requests lose only cache state their seed rebuilds, so
        they are requeued too (ahead of the granted ones: they are older);
        running requests are FAILED; the pool restarts empty."""
        # a granted request that page pressure already sent back to the
        # queue this step is QUEUED too: requeue only those not there
        requeued = [r for r in granted if r.state is RequestState.QUEUED
                    and all(r is not q for q in self.scheduler.queue)]
        self.scheduler.requeue_front(requeued)
        for req in requeued:
            self.timelines.record(req.request_id, "requeued",
                                  reason="admit_error")
        prefilling = sorted((r for r in self._slot_req.values()
                             if r.state is RequestState.PREFILLING),
                            key=lambda r: r.request_id)
        for req in prefilling:
            del self._slot_req[req.slot]
            req.slot = None
            req.admit_time = None
            req.prefill_pos = 0
            self.timelines.record(req.request_id, "requeued",
                                  reason="step_error")
        self.scheduler.requeue_front(prefilling)
        self._prefill_queue.clear()
        for req in self._slot_req.values():
            req.state = RequestState.FAILED
            req.finish_reason = FinishReason.ERROR
            req.finish_time = self._now()
            self.metrics.record_failure(req)
            self.timelines.record(req.request_id, "failed", terminal=True,
                                  reason=FinishReason.ERROR.value)
        self._slot_req.clear()
        if self._handoff_ready:
            self._handoff_ready.clear()   # every member was seated: FAILED
        self._deferred.clear()
        self._cur.zero_()
        self.pool.reset()

    def run_until_drained(self, max_steps: Optional[int] = None,
                          stall_patience: int = 32) -> List[Request]:
        """Step until the queue and every slot are empty (or ``max_steps``).
        A progress signature that stays identical for ``stall_patience``
        steps raises :class:`ServingStalledError` (with a post-mortem)
        instead of spinning."""
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
                    err = ServingStalledError(
                        f"no progress for {still} consecutive steps "
                        f"(step_id={self.step_id}, pending="
                        f"{self.scheduler.pending}, live="
                        f"{self.live_count}); stuck requests: {dump}",
                        dump=dump)
                    self._post_mortem("stalled", err,
                                      extra={"stuck": dump})
                    raise err
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
                 "preemptions": r.preemptions,
                 "deadline_ms": r.deadline_ms} for r in reqs]

    def check_invariants(self) -> None:
        """Audit engine/pool/scheduler bookkeeping; raises
        :class:`InvariantViolation` listing every violation (and writes a
        post-mortem): the pool's own audit (with paged KV: refcounts
        against held references, leaked pages, unbacked live positions),
        leaked or doubly-owned slots, a slot map that disagrees with its
        requests, seated or queued requests in the wrong state, a prefill
        queue that disagrees with the PREFILLING requests, lengths outside
        the allocation."""
        errors = list(self.pool.consistency_errors())
        seated = set(self._slot_req.keys())
        free = set(self.pool._free_set)
        both = seated & free
        if both:
            errors.append(f"slots both seated and free: {sorted(both)}")
        bad = sorted(s for s in seated if not 0 <= s < self.pool.num_slots)
        if bad:
            errors.append(f"seated slots out of range [0, "
                          f"{self.pool.num_slots}): {bad}")
            seated -= set(bad)
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
        for r in (self._handoff_ready or ()):
            # a parked handoff must still be a live seat here: anything
            # else means a retire or transfer path forgot to drop it
            if r.state is not RequestState.RUNNING or r.slot is None \
                    or self._slot_req.get(r.slot) is not r:
                errors.append(f"handoff-ready req {r.request_id} not "
                              f"seated RUNNING (state={r.state.value}, "
                              f"slot={r.slot})")
        if errors:
            err = InvariantViolation(errors)
            self._post_mortem("invariant_violation", err,
                              extra={"violations": errors})
            raise err

    def stats(self) -> dict:
        """Aggregate SLO snapshot (see ``ServingMetrics.snapshot``) and
        ``spec_k`` (the draft length, 0 with speculation off); with paged
        KV a ``"paging"`` sub-dict carries the page-pool and prefix-cache
        counters (``PagedKVPool.page_stats``)."""
        snap = self.metrics.snapshot()
        snap["spec_k"] = int(self._spec.k) if self._spec is not None else 0
        snap["role"] = self.role
        if self._paged:
            snap["paging"] = self.pool.page_stats()
        return snap
