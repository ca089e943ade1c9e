"""The port's data-parallel replica router on the CPU (the cases of the JAX
``tests/unit/serving/test_router.py`` and ``test_disagg.py::TestElasticFleet``
that need no TPU; the JAX router's own tokens, hops and topology are held
in ``test_torch_disagg.py``).

The router is a dispatch layer: routing, spill, failover and scale events
never change a request's greedy tokens (``generate()``'s), ids stay unique
across replicas, session and prefix affinity beat least-loaded in a fixed
order, and no replica leaks a slot or a page after a drain, a failover or a
retire.
"""

import numpy as np
import pytest

from deepspeed_tpu_torch.serving import (ID_STRIDE, FinishReason,
                                         NoLiveReplicaError, ReplicaRouter,
                                         RequestState, ServingEngine)

from _torch_fleet import (BUDGETS, PS, assert_generated,
                          assert_no_page_leaks, make_prompts, paged_server,
                          port_engine, spawn_factory, warm)
from _torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def engine():
    return port_engine(seed=1, max_seq_len=128)


@pytest.fixture(scope="module")
def fleet_engine():
    return port_engine(seed=2)


def _mk(engine, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_queue_depth", 16)
    return ServingEngine(engine, **kw)


def _prompts(n, rng, lo=5, hi=12):
    return [rng.integers(0, 64, size=int(rng.integers(lo, hi + 1)))
            .astype(np.int32) for _ in range(n)]


def test_router_matches_single_engine(engine):
    rng = np.random.default_rng(11)
    prompts = _prompts(8, rng)
    budgets = [int(rng.integers(3, 8)) for _ in prompts]
    router = ReplicaRouter([_mk(engine), _mk(engine)])
    got = [router.submit(p, max_new_tokens=b)
           for p, b in zip(prompts, budgets)]
    router.run_until_drained(max_steps=400)
    assert_generated(engine, got, prompts, budgets)
    assert router.stats()["dispatched"] == [4, 4]


def test_router_ids_globally_unique(engine):
    rng = np.random.default_rng(5)
    router = ReplicaRouter([_mk(engine), _mk(engine), _mk(engine)])
    reqs = [router.submit(p, max_new_tokens=2) for p in _prompts(9, rng)]
    ids = [r.request_id for r in reqs]
    assert len(set(ids)) == len(ids)
    for r in reqs:
        assert r.request_id // ID_STRIDE == router._owner[r.request_id]
    router.run_until_drained(max_steps=400)


def test_owner_map_retired_with_tracking(engine):
    """Finishing and cancelling retire the ``_owner`` entry with
    ``_tracked`` (the JAX router's leak fix: ``_owner`` once kept every id
    ever routed)."""
    rng = np.random.default_rng(7)
    router = ReplicaRouter([_mk(engine), _mk(engine)])
    reqs = [router.submit(p, max_new_tokens=3) for p in _prompts(6, rng)]
    assert len(router._owner) == len(reqs)
    victim = reqs[-1]
    assert router.cancel(victim.request_id) is not None
    assert victim.request_id not in router._owner
    assert victim.request_id not in router._tracked
    router.run_until_drained(max_steps=400)
    assert router._tracked == {} and router._owner == {}
    router.check_invariants()
    router._owner[12345] = 0                       # a stale entry
    with pytest.raises(AssertionError, match="no longer tracked"):
        router.check_invariants()


def test_failover_requeues_to_sibling(engine):
    """A replica that dies mid-request re-homes every owed request; the
    resume re-prefills prompt + generated tokens and gives
    ``generate()``'s tokens."""
    rng = np.random.default_rng(23)
    prompts = _prompts(6, rng)
    budgets = [6] * len(prompts)
    rep_a, rep_b = _mk(engine), _mk(engine)
    router = ReplicaRouter([rep_a, rep_b])
    got = [router.submit(p, max_new_tokens=b)
           for p, b in zip(prompts, budgets)]
    router.step()
    router.step()
    assert any(r.output_tokens for r in got)
    rep_a.step = lambda: (_ for _ in ()).throw(RuntimeError("gone"))
    router.run_until_drained(max_steps=800)
    assert router.alive_replicas == [1]
    assert router.failovers > 0
    assert_generated(engine, got, prompts, budgets)
    assert all(g.finish_reason == FinishReason.LENGTH for g in got)
    router.check_invariants()
    assert rep_b.pool.free_count == rep_b.pool.num_slots
    assert rep_b.live_count == 0 and rep_b.scheduler.pending == 0


def test_all_replicas_dead_raises(engine):
    rng = np.random.default_rng(2)
    rep = _mk(engine)
    router = ReplicaRouter([rep])
    router.submit(_prompts(1, rng)[0], max_new_tokens=4)
    rep.step = lambda: (_ for _ in ()).throw(RuntimeError("boom"))
    with pytest.raises(NoLiveReplicaError):
        router.run_until_drained(max_steps=10)
    with pytest.raises(NoLiveReplicaError):
        router.submit(_prompts(1, rng)[0], max_new_tokens=4)


def test_affinity_vs_least_loaded_tiebreak_deterministic(engine):
    """Dispatch order: sticky session, prefix peek, least loaded, lowest
    index; two routers fed the same requests dispatch alike."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 64, size=3 * PS).astype(np.int32)
    tails = [rng.integers(0, 64, size=n).astype(np.int32)
             for n in (5, 3, 2 * PS, 5, 6, 2)]

    def drive():
        reps = [_mk(engine, prefill_chunk=PS,
                    paged_kv={"page_size": PS, "num_pages": 16})
                for _ in range(2)]
        router = ReplicaRouter(reps)
        trace = []
        r = router.submit(shared, max_new_tokens=2)
        trace.append(router._owner[r.request_id])       # empty: index 0
        router.run_until_drained(max_steps=200)
        reps[0].submit(tails[0], max_new_tokens=6)       # 0 busier
        r = router.submit(np.concatenate([shared, tails[1]]),
                          max_new_tokens=2)
        trace.append(router._owner[r.request_id])       # prefix wins
        r = router.submit(tails[2], max_new_tokens=2)
        trace.append(router._owner[r.request_id])       # least loaded
        reps[0].submit(tails[3], max_new_tokens=6)
        r = router.submit(tails[4], session="s1", max_new_tokens=2)
        trace.append(router._owner[r.request_id])       # cold session
        r = router.submit(np.concatenate([shared, tails[5]]),
                          session="s1", max_new_tokens=2)
        trace.append(router._owner[r.request_id])       # session sticks
        router.run_until_drained(max_steps=400)
        assert router.affinity_hits > 0
        return trace

    t1 = drive()
    assert t1 == [0, 0, 1, 1, 1]
    assert drive() == t1


def test_router_zero_leaks_after_failover_and_drain(engine):
    rng = np.random.default_rng(31)

    def mk_paged():
        return _mk(engine, prefill_chunk=PS, max_queue_depth=8,
                   paged_kv={"page_size": PS, "num_pages": 12})

    rep_a, rep_b, rep_c = mk_paged(), mk_paged(), mk_paged()
    router = ReplicaRouter([rep_a, rep_b, rep_c])
    reqs = [router.submit(p, max_new_tokens=4)
            for p in _prompts(10, rng, lo=6, hi=20)]
    router.step()
    rep_b.step = lambda: (_ for _ in ()).throw(RuntimeError("gone"))
    router.run_until_drained(max_steps=800)
    assert router.alive_replicas == [0, 2]
    router.check_invariants()
    for rep in (rep_a, rep_c):
        assert_no_page_leaks(rep)
        stats = rep.pool.page_stats()
        assert stats["pages_in_use"] == stats["prefix_evictable_pages"]
    assert all(r.state is RequestState.FINISHED for r in reqs)


# -- elasticity (JAX test_disagg.py::TestElasticFleet) ---------------------
def test_add_and_retire_under_load_drops_nothing(fleet_engine):
    """Scale events racing live traffic: nothing dropped, no page leak,
    and zero recompiles under strict watchdogs, the newcomer's too."""
    router = ReplicaRouter(
        [paged_server(fleet_engine, "prefill", strict_recompile=True),
         paged_server(fleet_engine, "decode", strict_recompile=True)])
    warm(router)
    spawn = spawn_factory(fleet_engine, strict_recompile=True)
    prompts = make_prompts(17)
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(prompts[:3], BUDGETS[:3])]
    for _ in range(4):
        router.step()
    i = router.add_replica(spawn("decode"), "decode")
    assert router.last_scale_event["action"] == "add"
    assert router.replicas[i].replica_id == i
    assert router.replicas[i].watchdog.warmed
    reqs += [router.submit(p, max_new_tokens=b)
             for p, b in zip(prompts[3:], BUDGETS[3:])]
    for _ in range(4):
        router.step()
    router.retire_replica(i)
    assert router.last_scale_event["action"] == "retire"
    router.run_until_drained(max_steps=800)
    router.check_invariants()
    # before generate(), whose calls to the shared engine's prefill are
    # watched too
    assert router.recompiles == 0
    assert_generated(fleet_engine, reqs, prompts, BUDGETS)
    assert len(router.scale_events) == 2
    for j in router.alive_replicas:
        assert_no_page_leaks(router.replicas[j])


def test_autoscale_spawns_on_sustained_pressure_and_retires_idle(
        fleet_engine):
    router = ReplicaRouter(
        [paged_server(fleet_engine, "prefill"),
         paged_server(fleet_engine, "decode")],
        spawner=spawn_factory(fleet_engine), scale_patience=2)
    warm(router)
    prompts = make_prompts(19) + make_prompts(23)
    budgets = BUDGETS + BUDGETS
    reqs = [router.submit(p, max_new_tokens=b)
            for p, b in zip(prompts, budgets)]
    router.run_until_drained(max_steps=1200)
    assert_generated(fleet_engine, reqs, prompts, budgets)
    assert [e for e in router.scale_events if e["action"] == "add"]
    for _ in range(40):
        router.step()
        if router.num_replicas - sum(e["action"] == "retire"
                                     for e in router.scale_events) <= 2:
            break
    assert [e for e in router.scale_events if e["action"] == "retire"]
    router.check_invariants()


def test_retire_refuses_to_strand_a_role(fleet_engine):
    router = ReplicaRouter([paged_server(fleet_engine, "prefill"),
                            paged_server(fleet_engine, "decode")])
    with pytest.raises(ValueError, match="prefill-capable"):
        router.retire_replica(0)
    with pytest.raises(ValueError, match="decode-capable"):
        router.retire_replica(1)
    with pytest.raises(ValueError, match="no decode-capable"):
        ReplicaRouter([paged_server(fleet_engine, "prefill")])
    with pytest.raises(ValueError, match="at least one"):
        ReplicaRouter([])
