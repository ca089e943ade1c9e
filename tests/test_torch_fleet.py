"""Fleet observability of the port on the CPU (the cases of the JAX
``tests/unit/serving/test_fleet_observability.py`` that need no TPU):
cross-replica journeys, the merged telemetry plane (``FleetTelemetry``) and
the one fleet post-mortem.

The hard scenario: a request prefilled on replica 0, handed to decode
replica 1, which is killed mid-stream. Its journey still reads as one
story (dispatch, transfer, failover, finish) across every home, its greedy
tokens are ``generate()``'s, and the merged Perfetto export has one process
lane per replica with flow arrows across the boundaries. The series names
and labels of the exposition are held against the JAX fleet's in
``test_torch_disagg.py``.
"""

import json
import os

import numpy as np
import pytest

from deepspeed_tpu_torch.serving import (InvariantViolation, ReplicaRouter,
                                         Request, RequestState)
from deepspeed_tpu_torch.telemetry import (FLEET_POST_MORTEM_KEYS,
                                           FLEET_SCHEMA_VERSION,
                                           FleetTelemetry, QuantileDigest,
                                           Tracer, WindowedQuantiles)

from _torch_fleet import (BUDGETS, assert_generated, make_prompts,
                          paged_server, port_engine, warm)
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def engine():
    return port_engine(seed=4)


def _server(engine, role, **kw):
    kw.setdefault("tracer", Tracer())
    kw.setdefault("slo", True)
    return paged_server(engine, role, **kw)


def _fleet(engine, roles, **kw):
    kw.setdefault("tracer", Tracer())
    return ReplicaRouter([_server(engine, r) for r in roles], **kw)


def _kill_a_busy_decode_replica(router):
    """Step until a decode replica holds live work, then make its step
    raise; returns its index."""
    for _ in range(200):
        router.step()
        victim = next((i for i in range(1, router.num_replicas)
                       if router._alive[i]
                       and router.replicas[i].live_count), None)
        if victim is not None:
            break
    assert victim is not None, "no request reached a decode home"
    router.replicas[victim].step = lambda: (_ for _ in ()).throw(
        RuntimeError("decode replica killed mid-stream"))
    return victim


def test_handoff_then_decode_death_is_one_complete_journey(engine):
    router = _fleet(engine, ["prefill", "decode", "decode"])
    warm(router)
    prompts = make_prompts(7)
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, BUDGETS)]
    victim = _kill_a_busy_decode_replica(router)
    router.run_until_drained(max_steps=800)
    assert not router._alive[victim] and router.failovers >= 1
    assert_generated(engine, reqs, prompts, BUDGETS)
    js = router.journey_summary()
    assert js["finished"] == js["total"] == js["complete"]
    multi = [router.journey(r.journey_id) for r in reqs]
    multi = [j for j in multi
             if any(h["kind"] == "failover" for h in j["hops"])]
    assert multi, "the failover left no journey hop"
    j = multi[0]
    assert j["complete"] and j["terminal"] == "finish"
    assert victim in j["homes"] and len(set(j["homes"])) >= 2
    kinds = [h["kind"] for h in j["hops"]]
    assert kinds[0] == "dispatch" and kinds[-1] == "finish"
    assert "transfer" in kinds and "failover" in kinds
    ts = [e["t_ns"] for e in j["events"]]
    assert ts == sorted(ts)
    evs = [e["event"] for e in j["events"]]
    assert "failed_over" in evs and "resumed" in evs and "adopted" in evs
    # every timeline event carries the replica it was recorded on
    assert all(e["attrs"]["replica"] == e["replica"] for e in j["events"]
               if e["source"] == "timeline")
    router.check_invariants()


def test_export_trace_merged_perfetto_document(engine, tmp_path):
    router = _fleet(engine, ["prefill", "decode"])
    warm(router)
    path = str(tmp_path / "fleet-trace.json")
    assert router.export_trace(path) > 0
    doc = json.load(open(path))
    events = doc["traceEvents"]
    assert {e["pid"] for e in events} == {0, 1, 2}
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert names[0] == "router"
    assert names[1] == "replica0:prefill" and names[2] == "replica1:decode"
    for ev in events:
        assert ev["ph"] in ("X", "i", "C", "b", "n", "e", "s", "f", "M"), ev
        if ev["ph"] == "f":
            assert ev.get("bp") == "e", ev
    starts = {(e["cat"], e["id"]): e["pid"] for e in events
              if e["ph"] == "s"}
    assert [e for e in events if e["ph"] == "f"
            and starts.get((e["cat"], e["id"])) not in (None, e["pid"])], \
        "no cross-lane flow arrow"


def test_parked_mid_handoff_journey_is_not_falsely_complete(engine):
    router = _fleet(engine, ["prefill", "decode"])
    warm(router)
    pre = router.replicas[0]
    req = router.submit(make_prompts(13)[2], max_new_tokens=4)
    for _ in range(40):
        pre.step()              # the prefill replica alone: no drain
        if req in pre.pending_handoffs():
            break
    assert req in pre.pending_handoffs()
    assert req.request_id in pre.timelines.parked_ids()
    j = router.journey(req.journey_id)
    assert not j["complete"] and j["parked_homes"] == [0]
    assert j["terminal"] is None
    assert router.fleet.health_summary()["replicas"]["0"][
        "parked_handoffs"] == 1
    router.run_until_drained(max_steps=400)
    assert req.state is RequestState.FINISHED
    j = router.journey(req.journey_id)
    assert j["complete"] and not j["parked_homes"]
    router.check_invariants()


def test_journeys_survive_zero_recompile_budget(engine):
    """Strict watchdogs on both replicas, which share one captured engine:
    zero recompiles after warmup with journeys, the merged exposition
    and the trace all on."""
    router = ReplicaRouter(
        [_server(engine, "prefill", strict_recompile=True),
         _server(engine, "decode", strict_recompile=True)],
        tracer=Tracer())
    warm(router)
    prompts = make_prompts(29)
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, BUDGETS)]
    router.run_until_drained(max_steps=600)
    router.fleet.to_prometheus()
    router.fleet.health_summary()
    router.fleet.efficiency_snapshot()
    assert router.recompiles == 0
    assert_generated(engine, reqs, prompts, BUDGETS)


def test_merged_prometheus_exposition(engine):
    router = _fleet(engine, ["prefill", "decode"])
    warm(router)
    prom = router.fleet.to_prometheus()
    assert "router_fleet_size 2" in prom
    assert "router_transfers_total" in prom
    assert "router_transfer_wire_bytes_total" in prom
    assert 'replica="0",role="prefill"' in prom
    assert 'replica="1",role="decode"' in prom
    for series in ("fleet_goodput", "fleet_burn_short",
                   "fleet_journeys_total", "fleet_journeys_complete",
                   "fleet_transfer_latency_p99_ms", "fleet_ttft_p99_ms"):
        assert series in prom, series
    type_lines = [ln for ln in prom.splitlines() if ln.startswith("# TYPE ")]
    assert len(type_lines) == len({ln.split()[2] for ln in type_lines})


def test_transfer_wire_bytes_and_latency_metrics(engine):
    router = _fleet(engine, ["prefill", "decode"])
    warm(router)
    prompts = make_prompts(7)
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, BUDGETS)]
    router.run_until_drained(max_steps=600)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    assert router.transfer_latency.count == router.transfers
    p99 = router.transfer_latency.quantile(0.99)
    assert p99 > 0
    snap = router.registry.snapshot()
    assert snap["router/transfer_wire_bytes_total"] == \
        router.transfer_bytes > 0
    assert snap["router/transfer_wire_bytes/count"] == router.transfers
    assert snap["router/transfer_wire_bytes/sum"] == router.transfer_bytes
    page = router.replicas[1].pool.page_nbytes
    assert router.transfer_bytes % page == 0
    eff = router.fleet.efficiency_snapshot()
    assert eff["transfer_latency_p99_ms"] == pytest.approx(p99)
    assert eff["journeys"]["complete"] == eff["journeys"]["finished"]
    assert eff["step_wall_s"] > 0 and "overhead_pct" in eff


def test_fleet_goodput_sums_windows_not_burns(engine):
    """Fleet goodput is what one tracker that saw every request reports:
    summed [admitted, good] pairs (2/10 and 8/8 pool to 10/18)."""
    router = _fleet(engine, ["prefill", "decode"])
    a, b = router.replicas[0].slo, router.replicas[1].slo
    for _ in range(10):
        a.observe_admitted()
    for _ in range(2):
        a.observe_finish(ttft_s=0.01, e2e_s=0.01)
    for _ in range(8):
        b.observe_admitted()
        b.observe_finish(ttft_s=0.01, e2e_s=0.01)
    g = router.fleet.goodput()
    assert g["admitted"] == 18 and g["good"] == 10
    assert g["goodput_slo"] == pytest.approx(10 / 18)
    assert g["alert_state"] in ("ok", "warn", "page")


def test_quantile_merge_accuracy_pinned():
    """Merging per-replica digests is as accurate as one digest that saw
    every sample, both within the digest's bound of numpy's percentile."""
    rng = np.random.default_rng(42)
    samples = rng.lognormal(mean=3.0, sigma=1.2, size=8000)
    merged = QuantileDigest()
    for shard in np.array_split(samples, 4):
        d = QuantileDigest()
        for v in shard:
            d.add(float(v))
        merged = merged.merge(d)
    one = QuantileDigest()
    for v in samples:
        one.add(float(v))
    assert merged.count == one.count == len(samples)
    for q in (0.5, 0.9, 0.99):
        exact = float(np.percentile(samples, q * 100))
        got = merged.quantile(q)
        assert got == pytest.approx(one.quantile(q))
        assert abs(got - exact) <= 2 * merged.rel_error * exact


def test_digest_param_mismatch_raises_and_is_counted(engine):
    with pytest.raises(ValueError):
        QuantileDigest().merge(QuantileDigest(rel_error=0.05))
    router = _fleet(engine, ["prefill", "decode"])
    warm(router)
    # a replica whose digests were built with other parameters is
    # skipped and counted, not merged wrongly
    router.replicas[1].slo.ttft = WindowedQuantiles(rel_error=0.05)
    router.replicas[1].slo.ttft.add(1.0)
    router.fleet.merged_digests()
    assert router.fleet.digest_merge_skipped == 1


def test_health_summary_per_replica_and_per_role(engine):
    router = _fleet(engine, ["prefill", "decode"])
    warm(router)
    hs = router.fleet.health_summary()
    assert set(hs["replicas"]) == {"0", "1"}
    assert hs["replicas"]["0"]["role"] == "prefill"
    assert hs["replicas"]["1"]["alert"] in ("ok", "warn", "page")
    assert set(hs["roles"]) == {"prefill", "decode"}
    for role in hs["roles"].values():
        assert {"replicas", "queue_depth", "backlog"} <= set(role)
    assert hs["journeys"]["complete"] == hs["journeys"]["finished"]
    assert hs["dead"] == [] and isinstance(router.fleet, FleetTelemetry)


def test_replica_death_dumps_one_fleet_scoped_file(engine, tmp_path):
    router = _fleet(engine, ["prefill", "decode", "decode"],
                    dump_dir=str(tmp_path))
    warm(router)
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(make_prompts(7), BUDGETS)]
    victim = _kill_a_busy_decode_replica(router)
    router.run_until_drained(max_steps=800)
    assert all(r.state is RequestState.FINISHED for r in reqs)
    files = [f for f in os.listdir(tmp_path)
             if f.startswith("fleet-postmortem")]
    assert len(files) == 1 and "replica_error" in files[0]
    pm = json.load(open(tmp_path / files[0]))
    assert set(pm) == set(FLEET_POST_MORTEM_KEYS)
    assert pm["schema_version"] == FLEET_SCHEMA_VERSION
    assert pm["trigger_replica"] == victim and pm["fleet_size"] == 3
    assert set(pm["replicas"]) == {"0", "1", "2"}
    assert sum(r["trigger"] for r in pm["replicas"].values()) == 1
    assert pm["replicas"][str(victim)]["trigger"] is True
    steps = [s for rep in pm["replicas"].values() for s in rep["steps"]]
    assert steps and all("t" in s and s["replica"] in (0, 1, 2)
                         for s in steps)
    assert pm["journeys"] and len(router.fleet.dumps) == 1


def test_invariant_violation_dumps_with_trigger(engine, tmp_path):
    router = _fleet(engine, ["prefill", "decode"], dump_dir=str(tmp_path))
    warm(router)
    router.replicas[1]._slot_req[99] = Request(999, np.zeros(4, np.int32), 4)
    with pytest.raises(InvariantViolation):
        router.check_invariants()
    del router.replicas[1]._slot_req[99]
    files = [f for f in os.listdir(tmp_path)
             if f.startswith("fleet-postmortem")]
    assert len(files) == 1
    pm = json.load(open(tmp_path / files[0]))
    assert pm["trigger_replica"] == 1 and pm["replicas"]["1"]["trigger"]


def test_dump_never_raises_without_dump_dir(engine):
    router = _fleet(engine, ["prefill", "decode"])
    assert router.fleet.dump("replica_error") is None
    assert router.fleet.dumps == []
