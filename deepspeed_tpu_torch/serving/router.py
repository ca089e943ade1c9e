"""Data-parallel replica router: one front door over N serving engines
(the port of ``deepspeed_tpu/serving/router.py``).

The router fronts N :class:`~deepspeed_tpu_torch.serving.engine.
ServingEngine` replicas, each with its own slot pool, scheduler and
captured steps, behind one ``submit``/``step``/``cancel`` surface shaped
like one engine, so the async front end (:mod:`.frontend.bridge`) drives a
router or a bare engine alike. Replicas may share one
:class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine` (and so its
weights and captured-step cache; each server's captures count against its
own watchdog) and one card.

Dispatch, in order:

1. **Session stickiness**: ``submit(..., session=key)`` pins a
   conversation's requests to the replica that served it last, so its
   prefix cache keeps paying across turns.
2. **Prefix affinity**: with paged KV, each replica's
   :class:`~deepspeed_tpu_torch.serving.prefix_cache.PrefixCache` is
   ``peek``-scored against the prompt (a pure read) and the longest
   full-page hit wins: skipped prefill chunks beat queue position.
3. **Least loaded**: fewest ``live + pending`` requests.
4. **Lowest replica index**: the deterministic tie-break; two routers fed
   the same requests dispatch alike.

Admission spill: when the chosen replica REJECTS (queue full, page
footprint), the remaining replicas are tried in the same order before the
rejection is returned.

Failure containment: a replica whose ``step()`` raises is marked dead and
never stepped again. Every request it still owed (queued, seated,
decoding, or FAILED by the engine's own abort) is scrubbed back to QUEUED
(``Request.seed_tokens`` carries prompt + generated tokens, so a greedy
resume re-prefills that history) and re-submitted to a surviving sibling.

Request ids stay unique across replicas: replica ``i``'s counter is offset
by ``i * ID_STRIDE``.

Disaggregated prefill/decode (the DistServe/Splitwise split): replicas
may carry a ``role``, ``"both"``, ``"prefill"`` (admission and prefill
only; finished prefills park in ``pending_handoffs()``) or ``"decode"``.
Submissions go to prefill-capable replicas, and after every fleet step the
router drains each prefill replica's parked handoffs: ``adopt`` copies the
request's live KV pages across pools (``PagedKVPool.import_pages``) onto a
decode replica chosen sticky-session first, then by a SHARED FIRST-PAGE
INDEX over the decode replicas' prefix tries (the handoff lands where the
prompt's first page is cached, and the transfer skips every trie-hit
page), then least loaded. Transfers complete within the drain:
``transfers_in_flight`` reads zero at every step boundary
(:meth:`ReplicaRouter.check_invariants`).

Fleet observability: every routed request carries a *journey*, a
fleet-unique trace context minted at submit and stamped on each home
replica's timeline events, and the router logs a hop at every boundary it
controls (dispatch, transfer, failover, terminal). :meth:`ReplicaRouter.
journey` stitches the record into one timeline; :meth:`ReplicaRouter.
export_trace` writes the fleet as ONE Perfetto document; ``router.fleet``
(:class:`~deepspeed_tpu_torch.telemetry.fleet.FleetTelemetry`) merges the
replicas' registries and digests and writes ONE fleet post-mortem when a
replica dies.

The fleet is elastic: :meth:`ReplicaRouter.add_replica` and
:meth:`ReplicaRouter.retire_replica` reshape it at runtime (a retirement
drains through the failover scrub), and :meth:`ReplicaRouter.
maybe_autoscale` drives both from the burn-rate signals: a role whose
replicas sustain a ``page`` alert (or saturation with a backlog) spawns a
sibling, a role idling with spare replicas retires one.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry.fleet import FleetTelemetry
from ..telemetry.registry import MetricsRegistry
from ..telemetry.slo import QuantileDigest
from ..telemetry.tracer import Tracer, export_merged
from ..telemetry.watchdog import RecompileAfterWarmupError
from .engine import ServingEngine
from .request import FinishReason, Request, RequestState
from .resilience import InvariantViolation, ServingStalledError

# id-space stride per replica: replica i issues ids in
# [i*ID_STRIDE, (i+1)*ID_STRIDE) — collision would need a billion
# requests through one replica in one process lifetime
ID_STRIDE = 1_000_000_000


class NoLiveReplicaError(RuntimeError):
    """Every replica has failed; the router can no longer make progress."""


class ReplicaRouter:
    """Route requests across data-parallel :class:`ServingEngine` replicas.

    ``replicas`` must be non-empty; they may share one
    :class:`~deepspeed_tpu_torch.inference.engine.InferenceEngine` and one
    card (data parallelism over replicas is a host-side construct).
    ``affinity=False``
    disables prefix-trie scoring (dispatch is then sticky-session →
    least-loaded only).

    Replicas over a model group above one rank: every rank of the world
    builds the same fleet over its own shards and runs the router in
    lockstep, fed the same calls in the same order. Dispatch (session,
    prefix peek, load, spill, failover, ``add_replica``,
    ``retire_replica``) reads only host state and the replicas' clock,
    rank 0's readings on every rank (``model_group.GroupClock``), so it
    is the same on every rank; a handoff moves each rank's own KV-head
    shard of the pages between the two pools that rank holds.
    """

    def __init__(self, replicas: Sequence[ServingEngine],
                 affinity: bool = True,
                 spawner: Optional[Any] = None,
                 scale_patience: int = 3,
                 tracer: Optional[Tracer] = None,
                 dump_dir: Optional[str] = None,
                 journey_capacity: int = 4096):
        if not replicas:
            raise ValueError("ReplicaRouter needs at least one replica")
        self.replicas: List[ServingEngine] = list(replicas)
        self.affinity = bool(affinity)
        self._alive: List[bool] = [True] * len(self.replicas)
        self.roles: List[str] = [getattr(r, "role", "both")
                                 for r in self.replicas]
        self._check_role_coverage(self.roles)
        for i, rep in enumerate(self.replicas):
            # offset, don't overwrite: a replica with prior traffic keeps
            # its issued ids unique within its own stripe
            rep._next_id += i * ID_STRIDE
            self._join_observability(i, rep)
        self._owner: Dict[int, int] = {}       # request_id -> replica idx
        self._session: Dict[str, int] = {}     # session key -> replica idx
        self._tracked: Dict[int, Request] = {}  # live (non-terminal) reqs
        self.dispatched = [0] * len(self.replicas)
        self.affinity_hits = 0
        self.spills = 0          # admissions that fell through to a sibling
        self.failovers = 0       # requests re-homed off a dead replica
        # -- disaggregation / elasticity --------------------------------
        self.transfers = 0       # completed prefill->decode handoffs
        self.transfer_bytes = 0
        self.prefix_routed = 0   # handoffs placed via the shared
        #                          first-page index (global prefix hit)
        self.transfer_pages_saved = 0  # pages a destination trie hit
        #                          kept off the wire (adopt hit_pages)
        self._transfers_in_flight = 0  # nonzero ONLY inside one drain
        self._req_session: Dict[int, str] = {}   # rid -> session key
        self._decode_session: Dict[str, int] = {}  # session -> decode idx
        self.spawner = spawner   # role -> ServingEngine factory (autoscale)
        self.scale_patience = int(scale_patience)
        self._hot_streak: Dict[str, int] = {}
        self._idle_streak: Dict[str, int] = {}
        self.scale_events: List[dict] = []
        self.last_scale_event: Optional[dict] = None
        self._warmed = False
        self.registry = MetricsRegistry()
        self.registry.add_collector(self._collect_metrics)
        # -- fleet observability ----------------------------------------
        # the router's OWN tracer: dispatch/transfer spans, failover
        # and scale-event instants — one extra process lane in the
        # merged Perfetto export. Disabled by default like the engine's.
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.tracer.process_name = "router"
        self.dump_dir = dump_dir
        # request journeys: jid -> {request_id, hops, homes, terminal},
        # a bounded log — the fleet post-mortem's dispatch record and
        # the stitcher's spine
        self._journey_seq = 0
        self._journey_capacity = int(journey_capacity)
        self._journeys: "OrderedDict[int, dict]" = OrderedDict()
        self._rid_journey: Dict[int, int] = {}
        self._journey_ns = 0       # self-timed bookkeeping (overhead_pct)
        # per-transfer wire latency, mergeable into the fleet exposition
        self.transfer_latency = QuantileDigest()
        self.fleet = FleetTelemetry(self, dump_dir=dump_dir)

    @staticmethod
    def _check_role_coverage(roles: Sequence[str]) -> None:
        for role in roles:
            if role not in ("both", "prefill", "decode"):
                raise ValueError(f"unknown replica role {role!r}")
        if any(r != "both" for r in roles):
            if not any(r in ("both", "prefill") for r in roles):
                raise ValueError("split-role fleet has no prefill-capable "
                                 "replica")
            if not any(r in ("both", "decode") for r in roles):
                raise ValueError("split-role fleet has no decode-capable "
                                 "replica")

    def _join_observability(self, i: int, rep: ServingEngine) -> None:
        """Stamp fleet identity onto a joining replica: ``replica_id``
        on the engine and its TimelineStore (every timeline event then
        carries ``replica=i`` for the journey stitcher) and a process
        name on its tracer (the Perfetto process-lane label in the
        merged export)."""
        rep.replica_id = i
        rep.timelines.replica_id = i
        rep.tracer.process_name = \
            f"replica{i}:{getattr(rep, 'role', 'both')}"

    def _collect_metrics(self) -> None:
        """Registry collector (runs at every snapshot/scrape): copy the
        router-owned counters in — ``router_fleet_size`` and
        ``router_transfers_total`` in ``/metrics``."""
        reg = self.registry
        reg.gauge("router/fleet_size").set(float(len(self.alive_replicas)))
        reg.counter("router/transfers_total").value = float(self.transfers)
        reg.counter("router/transfer_bytes_total").value = \
            float(self.transfer_bytes)
        # stats["bytes"] counts only pages that crossed pools (trie-hit
        # pages never move), so the bytes counter IS wire bytes
        reg.counter("router/transfer_wire_bytes_total").value = \
            float(self.transfer_bytes)
        reg.counter("router/failovers_total").value = float(self.failovers)
        reg.counter("router/journeys_total").value = \
            float(self._journey_seq)
        reg.counter("router/prefix_routed_total").value = \
            float(self.prefix_routed)
        reg.gauge("router/transfers_in_flight").set(
            float(self._transfers_in_flight))
        for role in ("prefill", "decode", "both"):
            idxs = self._role_indices(role)
            reg.gauge(f"router/replicas_{role}").set(float(len(idxs)))
            reg.gauge(f"router/load_{role}").set(
                float(sum(self._load(i) for i in idxs)))

    # -- introspection -------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    @property
    def alive_replicas(self) -> List[int]:
        return [i for i, a in enumerate(self._alive) if a]

    @property
    def live_count(self) -> int:
        return sum(r.live_count for i, r in enumerate(self.replicas)
                   if self._alive[i])

    @property
    def pending(self) -> int:
        return sum(r.scheduler.pending for i, r in enumerate(self.replicas)
                   if self._alive[i])

    @property
    def num_slots(self) -> int:
        """Total decode capacity across the alive fleet (the frontend's
        ``/healthz`` probe reads this where a single engine would report
        ``pool.num_slots``)."""
        return sum(self.replicas[i].pool.num_slots
                   for i in self.alive_replicas)

    @property
    def step_id(self) -> int:
        """Fleet progress marker: the furthest replica's step counter."""
        return max((self.replicas[i].step_id
                    for i in self.alive_replicas), default=0)

    @property
    def health_state(self) -> str:
        """Aggregate fleet load state for the frontend. Admission needs
        a prefill-capable replica and the router dispatches to the
        least-loaded one, so the fleet is only overloaded when EVERY
        prefill-capable replica is."""
        order = {"healthy": 0, "pressured": 1, "overloaded": 2}
        states = []
        for i in self.prefill_capable:
            lm = getattr(self.replicas[i], "_load", None)
            states.append(lm.state.name.lower() if lm is not None
                          else "healthy")
        if not states:
            return "overloaded"
        return min(states, key=lambda s: order.get(s, 0))

    def has_work(self) -> bool:
        """Any alive replica holding queued, prefilling or running work —
        the bridge's step-gate probe (duck-typed: it prefers a callable
        ``has_work`` over reading engine internals)."""
        return any(
            r.live_count or r.scheduler.pending
            or getattr(r, "_prefill_queue", None)
            for i, r in enumerate(self.replicas) if self._alive[i])

    def _now(self) -> float:
        return self.replicas[0]._now()

    # -- roles ---------------------------------------------------------
    def _role_indices(self, role: str) -> List[int]:
        return [i for i in self.alive_replicas if self.roles[i] == role]

    @property
    def prefill_capable(self) -> List[int]:
        """Alive replicas that can run admission ('prefill' or 'both')."""
        return [i for i in self.alive_replicas
                if self.roles[i] in ("prefill", "both")]

    @property
    def decode_capable(self) -> List[int]:
        """Alive replicas that can run the decode loop."""
        return [i for i in self.alive_replicas
                if self.roles[i] in ("decode", "both")]

    # -- request journeys ----------------------------------------------
    _TERMINAL_HOPS = ("finish", "reject", "cancel", "failed")

    def _mint_journey(self, req: Request) -> int:
        """Trace context for one request: a fleet-unique journey id
        (its own counter — request ids are striped per replica, so
        replica 0's ids would collide with a unified journey space)."""
        jid = self._journey_seq
        self._journey_seq += 1
        self._journeys[jid] = {"id": jid, "request_id": req.request_id,
                               "hops": [], "homes": [], "terminal": None}
        while len(self._journeys) > self._journey_capacity:
            _, old = self._journeys.popitem(last=False)
            self._rid_journey.pop(old["request_id"], None)
        self._rid_journey[req.request_id] = jid
        req.journey_id = jid
        return jid

    def _hop(self, req: Request, kind: str,
             replica: Optional[int] = None, **attrs) -> None:
        """Append one replica-boundary crossing to the request's
        journey (dispatch, transfer, failover, terminal). Self-timed:
        this is the router's only hot-path observability cost, and the
        fleet ``overhead_pct`` must charge it honestly."""
        t0 = time.perf_counter_ns()
        jid = req.journey_id
        rec = self._journeys.get(jid) if jid is not None else None
        if rec is not None:
            req.hop += 1
            hop = {"kind": kind, "hop": req.hop, "t": self._now(),
                   "replica": replica}
            hop.update(attrs)
            rec["hops"].append(hop)
            if replica is not None and replica not in rec["homes"]:
                rec["homes"].append(replica)
            if kind in self._TERMINAL_HOPS:
                rec["terminal"] = kind
        self._journey_ns += time.perf_counter_ns() - t0

    @property
    def journey_overhead_s(self) -> float:
        return self._journey_ns / 1e9

    def journey_of(self, request_id: int) -> Optional[int]:
        """Journey id for a request id (None once evicted/unknown)."""
        return self._rid_journey.get(request_id)

    def journey(self, journey_id: int) -> Optional[dict]:
        """The STITCHER: merge one journey's cross-replica record.

        Returns the router's hop log plus every home replica's timeline
        events for the request — each event stamped with its replica —
        in one list ordered on the shared ``perf_counter_ns`` clock
        (router hops carry the injected-clock ``t``, converted to ns on
        the same epoch when the default clock is in use). ``complete``
        is the fleet-truth probe: a terminal hop was recorded AND no
        home's timeline is still open or parked mid-handoff — a request
        stranded between homes is complete on NEITHER."""
        rec = self._journeys.get(journey_id)
        if rec is None:
            return None
        rid = rec["request_id"]
        events: List[dict] = []
        open_homes: List[int] = []
        parked_homes: List[int] = []
        for i, rep in enumerate(self.replicas):
            tl = rep.timelines.get(rid)
            if not tl:
                continue
            for e in tl:
                events.append({"t_ns": e["t_ns"], "replica": i,
                               "source": "timeline",
                               "event": e["event"], "attrs": e["attrs"]})
            if rep.timelines.is_open(rid):
                open_homes.append(i)
            if rid in rep.timelines.parked_ids():
                parked_homes.append(i)
        for h in rec["hops"]:
            events.append({"t_ns": int(h["t"] * 1e9),
                           "replica": h.get("replica"),
                           "source": "router", "event": h["kind"],
                           "attrs": {k: v for k, v in h.items()
                                     if k not in ("kind", "t")}})
        events.sort(key=lambda e: e["t_ns"])
        complete = (rec["terminal"] is not None
                    and not open_homes and not parked_homes)
        return {"id": journey_id, "request_id": rid,
                "hops": list(rec["hops"]), "homes": list(rec["homes"]),
                "terminal": rec["terminal"], "events": events,
                "complete": complete, "open_homes": open_homes,
                "parked_homes": parked_homes}

    def journey_summary(self) -> dict:
        """Fleet completeness rollup: of the journeys that reached a
        terminal hop, how many stitch COMPLETE (every home's timeline
        closed, none parked). The ``--require-complete-journeys`` gate
        holds ``complete == finished``."""
        finished = complete = 0
        incomplete: List[int] = []
        for jid, rec in list(self._journeys.items()):
            if rec["terminal"] is None:
                continue
            finished += 1
            j = self.journey(jid)
            if j is not None and j["complete"]:
                complete += 1
            else:
                incomplete.append(jid)
        return {"total": len(self._journeys), "finished": finished,
                "complete": complete, "incomplete": incomplete[:16]}

    def recent_journeys(self, n: int = 32) -> List[dict]:
        """Tail of the journey log (hops only, no timeline merge) — the
        router's dispatch record inside the fleet post-mortem."""
        out = []
        for jid in list(self._journeys)[-n:]:
            rec = self._journeys[jid]
            out.append({"id": jid, "request_id": rec["request_id"],
                        "homes": list(rec["homes"]),
                        "terminal": rec["terminal"],
                        "hops": list(rec["hops"])})
        return out

    def export_trace(self, path: str) -> int:
        """Write ONE merged Perfetto document for the whole fleet: the
        router's lane first (dispatch spans, scale/failover instants),
        then one process lane per replica; flow arrows drawn at every
        handoff/transfer/failover pair render across lanes. Returns
        the event count."""
        tracers: List[Tuple[str, Tracer]] = [("router", self.tracer)]
        for i, rep in enumerate(self.replicas):
            tracers.append((f"replica{i}:{self.roles[i]}", rep.tracer))
        return export_merged(path, tracers)

    def _classify_failure(self, error: BaseException) -> str:
        if isinstance(error, InvariantViolation):
            return "invariant_violation"
        if isinstance(error, ServingStalledError):
            return "stalled"
        if isinstance(error, RecompileAfterWarmupError):
            return "recompile_after_warmup"
        return "replica_error"

    # -- dispatch ------------------------------------------------------
    def _load(self, i: int) -> int:
        r = self.replicas[i]
        return r.live_count + r.scheduler.pending

    def _rank(self, prompt, session: Optional[str]) -> List[int]:
        """Replica indices in dispatch-preference order. Admission (and
        failover re-admission, which re-prefills) only ever lands on
        prefill-capable replicas; decode-only replicas receive work
        exclusively through the handoff path."""
        alive = self.prefill_capable
        if not alive:
            if not self.alive_replicas:
                raise NoLiveReplicaError("all replicas have failed")
            raise NoLiveReplicaError("no prefill-capable replica alive")
        if session is not None:
            home = self._session.get(session)
            if home is not None and self._alive[home]:
                self.affinity_hits += 1
                return [home] + [i for i in alive if i != home]
        scores = {i: 0 for i in alive}
        if self.affinity:
            for i in alive:
                trie = getattr(self.replicas[i].pool, "prefix", None)
                if trie is not None:
                    scores[i] = int(trie.peek(prompt))
        # sort: longest prefix hit, then least loaded, then lowest index
        ranked = sorted(alive, key=lambda i: (-scores[i], self._load(i), i))
        if scores[ranked[0]] > 0:
            self.affinity_hits += 1
        return ranked

    def submit(self, prompt, session: Optional[str] = None,
               **kwargs: Any) -> Request:
        """Route one request. Same contract as ``ServingEngine.submit``
        (never raises on load; REJECTED carries a reason), plus
        ``session=`` stickiness. A rejection by the preferred replica
        spills to the next-ranked sibling; the LAST rejection is
        returned only when every alive replica refused."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        ranked = self._rank(prompt, session)
        req: Optional[Request] = None
        for n, i in enumerate(ranked):
            req = self.replicas[i].submit(prompt, **kwargs)
            if req.state is not RequestState.REJECTED:
                if n > 0:
                    self.spills += 1
                self.dispatched[i] += 1
                self._owner[req.request_id] = i
                self._tracked[req.request_id] = req
                if session is not None:
                    self._session[session] = i
                    self._req_session[req.request_id] = session
                self._mint_journey(req)
                self._hop(req, "dispatch", replica=i, spills=n)
                return req
        if req is not None:
            # every replica rejected: the journey still exists (and is
            # terminal) so a refused request audits like any other
            self._mint_journey(req)
            self._hop(req, "reject",
                      reason=str(req.reject_reason)
                      if req.reject_reason else None)
        return req  # every replica rejected: surface the last verdict

    # -- stepping ------------------------------------------------------
    def step(self) -> List[Request]:
        """One iteration of every alive replica. A replica that raises is
        retired and its requests fail over to the ranked siblings; the
        error is contained, not propagated (mirrors a multi-host serving
        tier losing one worker). Raises :class:`NoLiveReplicaError` only
        when no replica survives to inherit the work."""
        finished: List[Request] = []
        for i, rep in enumerate(self.replicas):
            if not self._alive[i]:
                continue
            try:
                finished.extend(rep.step())
            except Exception as e:
                self._alive[i] = False
                # ONE fleet-scoped post-mortem before the scrub mutates
                # anything: every replica's ring + the router's journey
                # and scale log, trigger replica marked
                self.fleet.dump(self._classify_failure(e), error=e,
                                trigger_replica=i)
                self.tracer.instant("router/replica_failed", replica=i,
                                    reason=self._classify_failure(e))
                self._fail_over(i)
        self._drain_handoffs()
        for req in finished:
            self._hop(req, "finish",
                      replica=self._owner.get(req.request_id),
                      reason=str(req.finish_reason)
                      if req.finish_reason else None)
            self._tracked.pop(req.request_id, None)
            self._owner.pop(req.request_id, None)
            self._req_session.pop(req.request_id, None)
        if self.spawner is not None:
            self.maybe_autoscale(self.spawner)
        if not any(self._alive):
            raise NoLiveReplicaError("all replicas have failed")
        return finished

    def _fail_over(self, dead: int) -> None:
        """Re-home every request the dead replica still owed.

        The engine's own ``_abort_step`` has already rolled its state to
        one of three shapes — QUEUED in its scheduler, seated in
        ``_slot_req`` (when the failure bypassed the abort path), or
        FAILED with reason ``error`` — and ``check_invariants`` on the
        corpse is meaningless. The router scrubs each survivor back to a
        fresh QUEUED request (keeping ``output_tokens``: they are the
        resume seed) and re-submits through a sibling's admission
        control, so capacity limits still hold under failover."""
        rep = self.replicas[dead]
        owed: List[Request] = []
        seen: set = set()

        def _take(req: Request) -> None:
            if id(req) in seen:
                return
            seen.add(id(req))
            owed.append(req)

        for r in list(rep.scheduler.queue):
            _take(r)
        rep.scheduler.queue.clear()
        for r in list(rep._slot_req.values()):
            _take(r)
        rep._slot_req.clear()
        rep._prefill_queue[:] = []
        if getattr(rep, "_handoff_ready", None):
            rep._handoff_ready.clear()
        # FAILED-by-abort requests the router still tracks: the engine
        # already charged the failure, but the CLIENT contract is that a
        # replica loss is invisible — resurrect and re-home them too
        for rid, r in list(self._tracked.items()):
            if self._owner.get(rid) == dead \
                    and r.state is RequestState.FAILED \
                    and r.finish_reason is FinishReason.ERROR:
                _take(r)
        owed.sort(key=lambda r: r.request_id)  # oldest first, deterministic
        for r in owed:
            if r.state in (RequestState.FINISHED, RequestState.REJECTED):
                continue
            r.state = RequestState.QUEUED
            r.slot = None
            r.prefill_pos = 0
            r.admit_time = None
            r.finish_reason = None
            r.finish_time = None
            r.preemptions += 1
            placed = False
            for i in self._rank(r.seed_tokens, None):
                accepted, _ = self.replicas[i].scheduler.submit(r)
                if accepted:
                    self._owner[r.request_id] = i
                    self._tracked[r.request_id] = r
                    self.failovers += 1
                    placed = True
                    # close the corpse's timeline (terminal: nothing
                    # more will ever be recorded there) and open the
                    # re-home on the inheritor, flow arrow across lanes
                    rep.timelines.record(
                        r.request_id, "failed_over", terminal=True,
                        src_replica=dead, dst_replica=i,
                        journey=r.journey_id)
                    self.replicas[i].timelines.record(
                        r.request_id, "resumed", src_replica=dead,
                        dst_replica=i, journey=r.journey_id,
                        preemptions=r.preemptions)
                    if r.journey_id is not None:
                        rep.tracer.flow("s", "journey", r.journey_id,
                                        cat="journey")
                        self.replicas[i].tracer.flow(
                            "f", "journey", r.journey_id, cat="journey")
                    self._hop(r, "failover", replica=i, src=dead)
                    break
            if not placed:
                r.state = RequestState.FAILED
                r.finish_reason = FinishReason.ERROR
                r.finish_time = self._now()
                rep.timelines.record(r.request_id, "failed",
                                     terminal=True, src_replica=dead,
                                     journey=r.journey_id)
                self._hop(r, "failed", src=dead)
                self._tracked.pop(r.request_id, None)
                self._owner.pop(r.request_id, None)
        # sticky sessions homed on the corpse re-route on next submit
        for key, idx in list(self._session.items()):
            if idx == dead:
                del self._session[key]

    # -- disaggregated handoff orchestration ---------------------------
    def _first_page_index(self) -> Dict[tuple, int]:
        """The SHARED first-page index: first-page token tuple -> decode
        replica whose prefix trie caches it. Rebuilt from the alive
        decode pool's trie roots once per drain (root children ARE the
        first-page edges), so prefix-affine handoff placement scores
        hits across the WHOLE decode pool instead of one sticky
        replica. Ties go to the lowest index — deterministic routing."""
        index: Dict[tuple, int] = {}
        for i in self.decode_capable:
            trie = getattr(self.replicas[i].pool, "prefix", None)
            if trie is None:
                continue
            for key in trie.root.children:
                index.setdefault(key, i)
        return index

    def _pick_decode(self, req: Request,
                     index: Dict[tuple, int]) -> Optional[int]:
        """Decode replica for one handoff: sticky session first (the
        conversation's earlier turns already decoded there), then the
        shared first-page index (global prefix affinity — the transfer
        itself shrinks by every trie-hit page), then least loaded.
        Only replicas with a free slot qualify; ``None`` means park the
        request and retry next step."""
        ready = [i for i in self.decode_capable
                 if self.replicas[i].pool._free_set]
        if not ready:
            return None
        session = self._req_session.get(req.request_id)
        if session is not None:
            home = self._decode_session.get(session)
            if home in ready:
                self.affinity_hits += 1
                return home
        if self.affinity:
            seed = np.asarray(req.seed_tokens).reshape(-1)
            ps = getattr(self.replicas[ready[0]].pool, "page_size", 0)
            if ps and len(seed) >= ps:
                key = tuple(int(t) for t in seed[:ps])
                home = index.get(key)
                if home in ready:
                    self.prefix_routed += 1
                    return home
        return min(ready, key=lambda i: (self._load(i), i))

    def _transfer(self, req: Request, src_idx: int,
                  index: Dict[tuple, int]) -> bool:
        """Move one parked request from prefill replica ``src_idx`` to a
        decode replica: ``adopt`` copies+seats the pages over there,
        ``finish_handoff`` releases the source seat. The in-flight
        counter brackets exactly this window — it must be zero again at
        every step boundary. A failed adopt leaves the request parked
        on the source (nothing seated on the destination — adopt
        unwinds) for retry; a destination WEDGED enough to raise is
        retired through the same path as a step failure."""
        src = self.replicas[src_idx]
        dst_idx = self._pick_decode(req, index)
        if dst_idx is None:
            return False
        dst = self.replicas[dst_idx]
        src_slot = req.slot
        jid = req.journey_id
        self._transfers_in_flight += 1
        if jid is not None:
            # flow start on the SOURCE lane; the finish lands on the
            # destination lane after adoption — the arrow crosses the
            # process boundary in the merged export
            src.tracer.flow("s", "journey", jid, cat="journey")
        try:
            with self.tracer.span("router/transfer", journey=jid,
                                  src=src_idx, dst=dst_idx,
                                  request=req.request_id):
                stats = dst.adopt(req, src)
        except Exception as e:
            # mid-transfer death: adopt already unwound every page it
            # touched on the destination; the request is STILL seated on
            # the source, still parked, and retries on a sibling
            self._alive[dst_idx] = False
            self.fleet.dump(self._classify_failure(e), error=e,
                            trigger_replica=dst_idx)
            self._fail_over(dst_idx)
            return False
        finally:
            self._transfers_in_flight -= 1
        src.finish_handoff(req, src_slot, dst_replica=dst_idx)
        if jid is not None:
            dst.tracer.flow("f", "journey", jid, cat="journey")
        self._owner[req.request_id] = dst_idx
        self.transfers += 1
        wire_bytes = int(stats["bytes"])
        self.transfer_bytes += wire_bytes
        self.transfer_pages_saved += int(stats.get("hit_pages", 0))
        self.transfer_latency.add(stats["seconds"] * 1e3)
        self.registry.histogram("router/transfer_ms").observe(
            stats["seconds"] * 1e3)
        self.registry.histogram("router/transfer_pages",
                                buckets=(1, 2, 4, 8, 16, 32, 64)).observe(
            float(stats["pages"]))
        self.registry.histogram(
            "router/transfer_wire_bytes",
            buckets=(1024, 4096, 16384, 65536, 262144, 1048576,
                     4194304, 16777216)).observe(float(wire_bytes))
        self._hop(req, "transfer", replica=dst_idx, src=src_idx,
                  pages=int(stats["pages"]),
                  hit_pages=int(stats.get("hit_pages", 0)),
                  bytes=wire_bytes, ms=stats["seconds"] * 1e3)
        session = self._req_session.get(req.request_id)
        if session is not None:
            self._decode_session[session] = dst_idx
        return True

    def _drain_handoffs(self) -> None:
        """After every fleet step: hand each prefill replica's finished
        prefills to the decode pool. Transfers complete synchronously
        here (the engines' step loops never observe a half-moved
        request)."""
        srcs = [i for i in self.alive_replicas
                if self.roles[i] == "prefill"
                and self.replicas[i].pending_handoffs()]
        if not srcs:
            return
        index = self._first_page_index() if self.affinity else {}
        for i in srcs:
            if not self._alive[i]:
                continue  # retired by a failover during this drain
            for req in self.replicas[i].pending_handoffs():
                if self._transfer(req, i, index):
                    # the adopted prompt is now cached on the destination
                    # trie; keep the index current within this drain
                    if self.affinity:
                        index = self._first_page_index()

    # -- elasticity ----------------------------------------------------
    def add_replica(self, replica: ServingEngine,
                    role: Optional[str] = None) -> int:
        """Scale-out: join a replica to the rotation at runtime. The
        newcomer must arrive TRAFFIC-WARMED (its provisioner drove a
        warm sweep through every program family it will serve, the same
        way the benches warm an arm before ``end_warmup``): when the
        fleet is already past warmup the newcomer's watchdog arms
        immediately, so a scale event records no new signature or capture
        after warmup (pinned by test). Returns the new replica index."""
        role = role if role is not None else getattr(replica, "role", "both")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        i = len(self.replicas)
        replica._next_id += i * ID_STRIDE
        self.replicas.append(replica)
        self._alive.append(True)
        self.roles.append(role)
        self.dispatched.append(0)
        self._join_observability(i, replica)
        if self._warmed:
            replica.end_warmup()
        self._record_scale("add", i, role)
        return i

    def retire_replica(self, i: int) -> None:
        """Scale-in: drain replica ``i`` through the failover scrub
        (every request it owes — queued, mid-prefill, decoding, parked
        for handoff — re-homes on a sibling with its generated tokens
        as the resume seed; greedy output is bitwise identical) and
        remove it from rotation. Refuses to retire the last replica of
        a needed capability."""
        if not (0 <= i < len(self.replicas)) or not self._alive[i]:
            raise ValueError(f"replica {i} is not alive")
        survivors = [j for j in self.alive_replicas if j != i]
        if not survivors:
            raise ValueError("cannot retire the last alive replica")
        roles_left = [self.roles[j] for j in survivors]
        if not any(r in ("both", "prefill") for r in roles_left):
            raise ValueError("cannot retire the last prefill-capable "
                             "replica")
        if any(r != "both" for r in roles_left + [self.roles[i]]) \
                and not any(r in ("both", "decode") for r in roles_left):
            raise ValueError("cannot retire the last decode-capable "
                             "replica")
        self._alive[i] = False
        self._fail_over(i)
        self._record_scale("retire", i, self.roles[i])

    def _record_scale(self, action: str, idx: int, role: str) -> None:
        event = {"action": action, "replica": idx, "role": role,
                 "time": self._now(),
                 "fleet_size": len(self.alive_replicas)}
        self.scale_events.append(event)
        self.last_scale_event = event
        # instant marker on the router lane: scale events punctuate the
        # merged fleet trace alongside the journeys they reshape
        self.tracer.instant("router/scale", action=action, replica=idx,
                            role=role,
                            fleet_size=len(self.alive_replicas))

    def _role_hot(self, role: str, idxs: List[int]) -> bool:
        """Sustained-overload signal for one role: any replica paging on
        its burn-rate tracker, or (when no SLO tracker is configured)
        saturated slots with a backlog. A decode role's backlog is the
        fleet's PARKED HANDOFFS — pages filled upstream that cannot
        seat downstream — since the router never queues fresh
        submissions on a decode-only replica."""
        parked = sum(len(self.replicas[j].pending_handoffs())
                     for j in self.prefill_capable)
        for i in idxs:
            rep = self.replicas[i]
            slo = getattr(rep, "slo", None)
            if slo is not None and slo.alert_state == "page":
                return True
            backlog = rep.scheduler.pending
            if role in ("decode", "both"):
                backlog += parked
            if rep.live_count >= rep.pool.num_slots and backlog > 0:
                return True
        return False

    def _role_idle(self, idxs: List[int]) -> bool:
        return all(self._load(i) == 0
                   and not self.replicas[i].pending_handoffs()
                   for i in idxs)

    def maybe_autoscale(self, spawn) -> List[dict]:
        """One elasticity decision pass (called each step when a
        ``spawner`` is configured, or directly by an external control
        loop). Per role: ``scale_patience`` consecutive hot checks →
        ``spawn(role)`` joins a new replica of that role;
        ``scale_patience`` consecutive idle checks with spare capacity
        → the highest-indexed idle replica retires. Returns the scale
        events this pass produced."""
        before = len(self.scale_events)
        for role in ("prefill", "decode", "both"):
            idxs = self._role_indices(role)
            if not idxs:
                continue
            if self._role_hot(role, idxs):
                self._hot_streak[role] = self._hot_streak.get(role, 0) + 1
                self._idle_streak[role] = 0
                if self._hot_streak[role] >= self.scale_patience:
                    self.add_replica(spawn(role), role)
                    self._hot_streak[role] = 0
            elif self._role_idle(idxs):
                self._idle_streak[role] = self._idle_streak.get(role, 0) + 1
                self._hot_streak[role] = 0
                if self._idle_streak[role] >= self.scale_patience \
                        and len(idxs) > 1:
                    self.retire_replica(idxs[-1])
                    self._idle_streak[role] = 0
            else:
                self._hot_streak[role] = 0
                self._idle_streak[role] = 0
        return self.scale_events[before:]

    def fleet_topology(self) -> dict:
        """The ``/healthz`` fleet block: per-role alive counts, transfer
        progress, and the most recent scale event."""
        return {
            "roles": {role: self._role_indices(role)
                      for role in ("prefill", "decode", "both")
                      if self._role_indices(role)},
            "counts": {role: len(self._role_indices(role))
                       for role in ("prefill", "decode", "both")},
            "fleet_size": len(self.alive_replicas),
            "transfers_in_flight": self._transfers_in_flight,
            "transfers_total": self.transfers,
            "prefix_routed_total": self.prefix_routed,
            "last_scale_event": self.last_scale_event,
        }

    def run_until_drained(self, max_steps: Optional[int] = None,
                          stall_patience: Optional[int] = None
                          ) -> List[Request]:
        """Step until no alive replica has work (mirror of the engine
        method; ``stall_patience`` is accepted for signature parity but
        stall detection lives in each replica)."""
        del stall_patience
        out: List[Request] = []
        steps = 0
        while self.has_work():
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out

    # -- per-request / lifecycle ---------------------------------------
    def cancel(self, request_id: int) -> Optional[Request]:
        idx = self._owner.get(request_id)
        if idx is None or not self._alive[idx]:
            return None
        req = self.replicas[idx].cancel(request_id)
        if req is not None:
            self._hop(req, "cancel", replica=idx)
            self._tracked.pop(request_id, None)
            self._owner.pop(request_id, None)
        return req

    def end_warmup(self) -> None:
        self._warmed = True
        for i in self.alive_replicas:
            self.replicas[i].end_warmup()

    def check_invariants(self) -> None:
        """Cross-replica audit: every ALIVE replica's slot/queue/pool
        bookkeeping must hold (dead replicas are tombstones — their
        state was deliberately stripped by failover)."""
        # ownership entries may not outlive tracking: _owner and
        # _tracked are populated and retired together, so a stale
        # _owner key is an unbounded host-side leak
        try:
            stale = set(self._owner) - set(self._tracked)
            if stale:
                raise AssertionError(
                    f"router _owner map holds {len(stale)} request id(s) "
                    f"no longer tracked: {sorted(stale)[:5]}")
            # transfers are synchronous inside one drain: any in-flight
            # count surviving to a step boundary is an accounting leak
            if self._transfers_in_flight:
                raise AssertionError(
                    f"{self._transfers_in_flight} page transfer(s) still "
                    f"in flight at a step boundary")
        except AssertionError as e:
            self.fleet.dump("invariant_violation", error=e)
            raise
        for i in self.alive_replicas:
            rep = self.replicas[i]
            try:
                # every parked handoff must belong to a prefill-role
                # replica the router still tracks — an untracked parked
                # request can never be adopted and would pin its slot
                # forever
                for r in rep.pending_handoffs():
                    if self.roles[i] != "prefill":
                        raise AssertionError(
                            f"replica {i} (role {self.roles[i]}) holds "
                            f"parked handoff {r.request_id}")
                    if self._tracked.get(r.request_id) is not r:
                        raise AssertionError(
                            f"parked handoff {r.request_id} on replica "
                            f"{i} is not router-tracked")
                rep.check_invariants()
            except AssertionError as e:
                # a violated invariant ANYWHERE is a fleet event: dump
                # every ring, mark the replica that tripped
                self.fleet.dump("invariant_violation", error=e,
                                trigger_replica=i)
                raise

    @property
    def recompiles(self) -> int:
        """Post-warmup recompiles summed over alive replicas' watchdogs."""
        total = 0
        for i in self.alive_replicas:
            wd = self.replicas[i].watchdog
            if wd is not None:
                total += wd.recompiles
        return total

    def stats(self) -> dict:
        """Router-level counters plus each alive replica's SLO snapshot."""
        return {
            "replicas": self.num_replicas,
            "alive": self.alive_replicas,
            "roles": list(self.roles),
            "dispatched": list(self.dispatched),
            "affinity_hits": self.affinity_hits,
            "spills": self.spills,
            "failovers": self.failovers,
            "transfers": self.transfers,
            "transfer_bytes": self.transfer_bytes,
            "transfer_pages_saved": self.transfer_pages_saved,
            "prefix_routed": self.prefix_routed,
            "scale_events": len(self.scale_events),
            "fleet": self.fleet_topology(),
            "journeys": self.journey_summary(),
            "router_metrics": self.registry.snapshot(),
            "per_replica": {i: self.replicas[i].stats()
                            for i in self.alive_replicas},
        }
