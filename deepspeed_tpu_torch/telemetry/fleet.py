"""Fleet telemetry: one merged view over the replicas of a
:class:`~deepspeed_tpu_torch.serving.router.ReplicaRouter` (the port's copy
of ``deepspeed_tpu/telemetry/fleet.py``).

Each :class:`~deepspeed_tpu_torch.serving.engine.ServingEngine` keeps its
own tracer, timeline store, metrics registry, SLO tracker and flight
recorder; :class:`FleetTelemetry` joins them into the fleet-level surfaces
the front end and a benchmark read:

* :meth:`to_prometheus`: ONE exposition over every alive replica's
  registry. Router series stay unlabeled (they are fleet-scope already);
  replica series gain ``replica="i",role="..."`` labels; ``fleet_*``
  series come from MERGING the replicas' SLO state: the
  :class:`~.slo.QuantileDigest` rings add bucketwise (same parameters),
  and goodput and burn come from SUMMED ``[admitted, good]`` window pairs,
  which is the one tracker that saw every request (averaging per-replica
  burn rates would weigh a replica with 2 requests like one with 2000).
* :meth:`health_summary`: the ``/healthz`` fleet block, per-replica alert
  states and per-role queue depth and backlog (a decode role's backlog is
  the fleet's parked handoffs).
* :meth:`efficiency_snapshot`: fleet goodput, transfer latency p99,
  journey completeness and ``overhead_pct`` over the summed step wall.
* :meth:`post_mortem` / :meth:`dump`: a fatal condition on ANY replica
  (``InvariantViolation``, ``ServingStalledError``, a strict recompile, a
  step that raised) gives ONE fleet-scoped file: every replica's
  flight-recorder ring and the router's journey and scale-event log,
  aligned on the shared injected clock, the triggering replica marked.

All of it is host-side aggregation of state already recorded: no device
work.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from .flight_recorder import _json_default
from .registry import Counter, Gauge, Histogram, _sanitize
from .slo import QuantileDigest

FLEET_SCHEMA_VERSION = 1

# keys every persisted fleet post-mortem carries; pinned by tests so
# external tooling can rely on the file shape
FLEET_POST_MORTEM_KEYS = ("schema_version", "reason", "error",
                          "time_unix", "t", "trigger_replica",
                          "fleet_size", "roles", "scale_events",
                          "journeys", "router", "replicas")

_ALERT_ORDER = {"ok": 0, "warn": 1, "page": 2}


class FleetTelemetry:
    """Merged observability surface over a :class:`ReplicaRouter`."""

    def __init__(self, router, dump_dir: Optional[str] = None):
        self.router = router
        self.dump_dir = dump_dir
        self.dumps: List[str] = []
        self.dump_failures = 0
        # digest merges refused for mismatched bucket parameters — a
        # misconfigured fleet shows up as a counter, not a lost scrape
        self.digest_merge_skipped = 0

    # -- iteration helpers ---------------------------------------------
    def _rows(self):
        """(index, role, replica) for every ALIVE replica."""
        r = self.router
        return [(i, r.roles[i], r.replicas[i]) for i in r.alive_replicas]

    # -- merged SLO state ----------------------------------------------
    def merged_digests(self) -> Dict[str, QuantileDigest]:
        """Fleet-wide ttft/gap/e2e digests: bucketwise sums of every
        replica's windowed rings. Replicas whose digest parameters
        differ from the first seen are skipped (and counted)."""
        out: Dict[str, QuantileDigest] = {}
        for _, _, rep in self._rows():
            slo = getattr(rep, "slo", None)
            if slo is None:
                continue
            for name in ("ttft", "gap", "e2e"):
                part = getattr(slo, name).merged()
                have = out.get(name)
                if have is None:
                    out[name] = part
                    continue
                try:
                    have.merge(part)
                except ValueError:
                    self.digest_merge_skipped += 1
        return out

    def goodput(self) -> Dict[str, Any]:
        """Fleet goodput + two-horizon burn over SUMMED window pairs."""
        short_pairs: List[List[int]] = []
        all_pairs: List[List[int]] = []
        cfg = None
        admitted = finished = good = 0
        for _, _, rep in self._rows():
            slo = getattr(rep, "slo", None)
            if slo is None:
                continue
            if cfg is None:
                cfg = slo.config
            wc = slo.window_counts()
            short_pairs.extend(wc["short"])
            all_pairs.extend(wc["all"])
            admitted += slo.admitted_total
            finished += slo.finished_total
            good += slo.good_total
        def _gp(pairs):
            a = sum(p[0] for p in pairs)
            return (sum(p[1] for p in pairs) / a) if a else 1.0
        gp_short, gp_long = _gp(short_pairs), _gp(all_pairs)
        target = cfg.goodput_target if cfg is not None else 0.95
        budget = max(1e-9, 1.0 - target)
        burn_short = max(0.0, 1.0 - gp_short) / budget
        burn_long = max(0.0, 1.0 - gp_long) / budget
        if cfg is not None and burn_short >= cfg.page_burn \
                and burn_long >= cfg.page_burn:
            alert = "page"
        elif cfg is not None and burn_short >= cfg.warn_burn \
                and burn_long >= cfg.warn_burn:
            alert = "warn"
        else:
            alert = "ok"
        return {"goodput_slo": gp_long, "goodput_short": gp_short,
                "burn_short": burn_short, "burn_long": burn_long,
                "alert_state": alert, "admitted": admitted,
                "finished": finished, "good": good}

    def fleet_series(self) -> Dict[str, float]:
        """The derived ``fleet/*`` gauges the exposition carries."""
        r = self.router
        gp = self.goodput()
        out = {
            "fleet/replicas_alive": float(len(r.alive_replicas)),
            "fleet/goodput": gp["goodput_slo"],
            "fleet/burn_short": gp["burn_short"],
            "fleet/burn_long": gp["burn_long"],
            "fleet/alert_level": float(_ALERT_ORDER[gp["alert_state"]]),
        }
        for name, d in self.merged_digests().items():
            if d.count:
                out[f"fleet/{name}_p50_ms"] = d.quantile(0.5)
                out[f"fleet/{name}_p99_ms"] = d.quantile(0.99)
        tl = getattr(r, "transfer_latency", None)
        if tl is not None and tl.count:
            out["fleet/transfer_latency_p50_ms"] = tl.quantile(0.5)
            out["fleet/transfer_latency_p99_ms"] = tl.quantile(0.99)
        js = r.journey_summary()
        out["fleet/journeys_total"] = float(js["total"])
        out["fleet/journeys_finished"] = float(js["finished"])
        out["fleet/journeys_complete"] = float(js["complete"])
        out["fleet/timelines_evicted_open"] = float(sum(
            rep.timelines.evicted_open for _, _, rep in self._rows()))
        return out

    # -- Prometheus exposition -----------------------------------------
    def to_prometheus(self) -> str:
        """One fleet exposition: router series (unlabeled), derived
        ``fleet_*`` gauges, then every replica's series labeled
        ``replica="i",role="..."`` — one ``# TYPE`` line per name,
        samples grouped under it, histograms with merged labels."""
        lines: List[str] = []
        router_text = self.router.registry.to_prometheus()
        if router_text:
            lines.append(router_text.rstrip("\n"))
        series = self.fleet_series()
        for name in sorted(series):
            n = _sanitize(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {series[name]:g}")
        groups: Dict[str, List] = {}
        for i, role, rep in self._rows():
            labels = f'replica="{i}",role="{role}"'
            for m in rep.registry.metrics():
                groups.setdefault(m.name, []).append((labels, m))
        for name in sorted(groups):
            entries = groups[name]
            kinds = {type(m) for _, m in entries}
            if len(kinds) != 1:
                continue  # type forked across replicas: skip, don't lie
            kind = kinds.pop()
            n = _sanitize(name)
            if kind is Counter:
                lines.append(f"# TYPE {n} counter")
                for labels, m in entries:
                    lines.append(f"{n}{{{labels}}} {m.value:g}")
            elif kind is Gauge:
                lines.append(f"# TYPE {n} gauge")
                for labels, m in entries:
                    lines.append(f"{n}{{{labels}}} {m.value:g}")
            elif kind is Histogram:
                lines.append(f"# TYPE {n} histogram")
                for labels, m in entries:
                    cum = 0
                    for j, b in enumerate(m.buckets):
                        cum += m.counts[j]
                        lines.append(
                            f'{n}_bucket{{{labels},le="{b:g}"}} {cum}')
                    lines.append(
                        f'{n}_bucket{{{labels},le="+Inf"}} {m.count}')
                    lines.append(f"{n}_sum{{{labels}}} {m.total:g}")
                    lines.append(f"{n}_count{{{labels}}} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- /healthz fleet block ------------------------------------------
    def health_summary(self) -> Dict[str, Any]:
        r = self.router
        replicas: Dict[str, Any] = {}
        parked_total = 0
        for i, role, rep in self._rows():
            slo = getattr(rep, "slo", None)
            parked = len(rep.pending_handoffs())
            parked_total += parked
            replicas[str(i)] = {
                "role": role,
                "alert": slo.alert_state if slo is not None else "ok",
                "live": rep.live_count,
                "pending": rep.scheduler.pending,
                "parked_handoffs": parked,
                "open_timelines": len(rep.timelines.open_ids()),
                "step_id": rep.step_id,
            }
        roles: Dict[str, Any] = {}
        for role in ("prefill", "decode", "both"):
            idxs = r._role_indices(role)
            if not idxs:
                continue
            depth = sum(r.replicas[i].scheduler.pending for i in idxs)
            backlog = depth
            if role in ("decode", "both"):
                # pages filled upstream that cannot seat downstream
                backlog += parked_total
            roles[role] = {"replicas": len(idxs), "queue_depth": depth,
                           "backlog": backlog}
        gp = self.goodput()
        return {
            "alert_state": gp["alert_state"],
            "goodput": gp["goodput_slo"],
            "replicas": replicas,
            "dead": [i for i, a in enumerate(r._alive) if not a],
            "roles": roles,
            "journeys": r.journey_summary(),
        }

    # -- bench-facing rollup -------------------------------------------
    def efficiency_snapshot(self) -> Dict[str, Any]:
        r = self.router
        overhead = sum(rep.telemetry_overhead_s
                       for _, _, rep in self._rows())
        overhead += r.journey_overhead_s
        wall = sum(rep.step_wall_s for _, _, rep in self._rows())
        gp = self.goodput()
        out: Dict[str, Any] = {
            "telemetry_overhead_s": overhead,
            "step_wall_s": wall,
            "goodput_slo": gp["goodput_slo"],
            "burn_short": gp["burn_short"],
            "alert_state": gp["alert_state"],
            "journeys": r.journey_summary(),
        }
        if wall:
            out["overhead_pct"] = 100.0 * overhead / wall
        tl = getattr(r, "transfer_latency", None)
        if tl is not None and tl.count:
            out["transfer_latency_p99_ms"] = tl.quantile(0.99)
        for name, d in self.merged_digests().items():
            if d.count:
                out[f"{name}_p99_ms"] = d.quantile(0.99)
        return out

    # -- fleet post-mortems --------------------------------------------
    def post_mortem(self, reason: str, error: Any = None,
                    trigger_replica: Optional[int] = None
                    ) -> Dict[str, Any]:
        """ONE fleet-scoped post-mortem dict: the router's journey and
        scale-event log plus EVERY replica's flight-recorder snapshot
        (dead replicas included — the corpse's ring is exactly the
        evidence), aligned on the shared clock each step record and
        journey hop stamped as ``t``."""
        r = self.router
        replicas: Dict[str, Any] = {}
        for i, rep in enumerate(r.replicas):
            rec = getattr(rep, "recorder", None)
            if rec is not None:
                snap = rec.snapshot(timelines=rep.timelines,
                                    registry=rep.registry,
                                    tracer=rep.tracer)
            else:
                snap = {"steps": [], "records_total": 0,
                        "open_timelines": {}, "registry": {},
                        "last_spans": []}
            snap.update(role=r.roles[i], alive=bool(r._alive[i]),
                        trigger=(i == trigger_replica),
                        step_id=rep.step_id)
            replicas[str(i)] = snap
        return {
            "schema_version": FLEET_SCHEMA_VERSION,
            "reason": reason,
            "error": repr(error) if error is not None else None,
            "time_unix": time.time(),
            "t": r._now(),
            "trigger_replica": trigger_replica,
            "fleet_size": len(r.replicas),
            "roles": list(r.roles),
            "scale_events": list(r.scale_events),
            "journeys": r.recent_journeys(),
            "router": {
                "dispatched": list(r.dispatched),
                "failovers": r.failovers,
                "transfers": r.transfers,
                "transfer_bytes": r.transfer_bytes,
                "registry": r.registry.snapshot(),
            },
            "replicas": replicas,
        }

    def dump(self, reason: str, error: Any = None,
             trigger_replica: Optional[int] = None) -> Optional[str]:
        """Write the fleet post-mortem JSON under ``dump_dir``; returns
        the path, or None without one. Never raises — the caller is
        already unwinding the real failure."""
        if not self.dump_dir:
            return None
        try:
            pm = self.post_mortem(reason, error=error,
                                  trigger_replica=trigger_replica)
            fname = (f"fleet-postmortem-{len(self.dumps):03d}-"
                     f"{reason}.json")
            path = os.path.join(self.dump_dir, fname)
            os.makedirs(self.dump_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(pm, f, indent=1, default=_json_default)
        except Exception:
            self.dump_failures += 1
            return None
        self.dumps.append(path)
        return path
