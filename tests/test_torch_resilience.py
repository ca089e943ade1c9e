"""Serving resilience of the port against the JAX package, on the CPU: the
scenarios of the JAX ``tests/unit/serving/test_resilience.py`` (fault
injector, reason enums, scheduler expiry, victims, the load-state machine,
deadlines, preemption including mid-chunk, degradation with speculation
suspended, the six chaos points, the stall guard), on the contiguous and
the paged pool.

Each engine scenario runs the same script through the JAX ``ServingEngine``
and the port's (eager, and over a ``enable_cuda_graph`` engine, whose
captured step runs its static-buffer body on the CPU), with the same
weights (``checkpoint.flax_import``), the same prompts (numpy, seeded), a
fake clock that the script advances by 10 ms a step, and each package's
``FaultInjector`` with the same seed and schedule (a fired
``slow_dispatch`` moves the fake clock by its ``slow_ms`` instead of
sleeping). Held exactly, between the packages: every request's state,
finish and reject reasons, output tokens, preemption count, retry hint and
class; the load state and the span and instant names of every step, in
order (the recompile instants aside: the JAX watchdog counts XLA compiles,
the port's new signatures); every request's timeline event names; the
registry counters both engines emit (``telemetry/*`` aside, for the same
reason); the exception each step raised; the keys of every post-mortem
written. Everything is fp32; the weights come from the JAX module's init,
so logits are far from ties.
"""

import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu.serving as js
import deepspeed_tpu.serving.resilience as jr
import deepspeed_tpu.telemetry as jt
from deepspeed_tpu.models import transformer_lm as J
from deepspeed_tpu.serving.metrics import ServingMetrics as JaxMetrics
from deepspeed_tpu.serving.resilience.degradation import \
    LoadStateMachine as JaxLoadStateMachine
from deepspeed_tpu.serving.resilience.preemption import \
    select_victims as jax_select_victims
import deepspeed_tpu_torch as dst
import deepspeed_tpu_torch.serving as ps
import deepspeed_tpu_torch.serving.resilience as pr
import deepspeed_tpu_torch.telemetry as pt
from deepspeed_tpu_torch.checkpoint.flax_import import state_dict_from_flax
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import (FIFOScheduler, FinishReason,
                                         RejectReason, Request, RequestState)
from deepspeed_tpu_torch.serving.metrics import ServingMetrics
from deepspeed_tpu_torch.serving.resilience import (DegradationConfig,
                                                    FaultInjector,
                                                    InjectedFault,
                                                    LoadState)
from deepspeed_tpu_torch.serving.resilience.degradation import \
    LoadStateMachine
from deepspeed_tpu_torch.serving.resilience.preemption import select_victims

from _torch_threads import one_thread  # noqa: F401


TINY = dict(vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2, n_head=4,
            dtype=jnp.float32)
PS = CHUNK = 16
POOLS = ("contiguous", "paged")
TICK = 0.01                  # fake-clock seconds per step
SIDES = {"jax": (js, jr, jt), "port": (ps, pr, pt)}


@pytest.fixture(scope="module")
def stack():
    jm = J.TransformerLM(J.transformer_config("gpt2", **TINY))
    params = jax.jit(lambda key: jm.init(
        {"params": key}, jnp.zeros((1, 8), jnp.int32),
        method=jm.logits))(jax.random.PRNGKey(1))["params"]
    jeng = ds.init_inference(model=jm, model_parameters=params,
                             config={"dtype": "float32"})
    pcfg = P.transformer_config("gpt2", **{**TINY, "dtype": torch.float32})
    state = state_dict_from_flax(pcfg,
                                 jax.tree_util.tree_map(np.asarray, params))
    engines = {"jax": jeng}
    for side, graph in (("port", False), ("port_graph", True)):
        engines[side] = dst.init_inference(
            P.TransformerLM(pcfg), model_parameters=state, device="cpu",
            config={"dtype": "float32", "enable_cuda_graph": graph})
    return engines


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def clocked_injector(mod, clock, **kw):
    """The package's FaultInjector whose ``slow_dispatch`` moves the fake
    clock by ``slow_ms`` instead of sleeping."""
    class Clocked(mod.FaultInjector):
        def maybe_sleep(self, point="slow_dispatch"):
            if self._roll(point):
                clock.t += self.slow_ms / 1e3
                return True
            return False

    return Clocked(**kw)


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, size=n).astype(np.int32) for n in lengths]


def serve(stack, side, pool, cfg, script=None, faults=None, warm=None,
          tweak=None, paged_extra=None, max_steps=300, tmp_path=None):
    """Run ``script`` ({step: [action, ...]}) on ``side``'s server: actions
    ("submit", prompt, kwargs), ("preempt", i), ("cancel", i) on the i-th
    submitted request. Each step's raised InjectedFault is caught and
    recorded; the fake clock advances TICK a step. Returns everything the
    tests hold, and the server."""
    mod, res, tel = SIDES["jax" if side == "jax" else "port"]
    engine = stack[side]
    clock = FakeClock()
    kw = dict(cfg)
    if pool == "paged":
        paged = {"page_size": PS, **(paged_extra or {})}
        kw["paged_kv"] = dict(paged, kernel="off") if side == "jax" \
            else paged
    fi = (clocked_injector(res, clock, seed=0, slow_ms=50.0)
          if faults is not None else None)
    dump_dir = None
    if tmp_path is not None:
        dump_dir = str(tmp_path / side)
    srv = mod.ServingEngine(engine, tracer=tel.Tracer(), clock=clock,
                            fault_injector=fi, dump_dir=dump_dir, **kw)
    if tweak is not None:
        tweak(srv)
    if warm:
        for wave in warm:
            for p, n in wave:
                srv.submit(p, max_new_tokens=n)
            srv.run_until_drained(max_steps=100)
        srv.end_warmup()
    if fi is not None:
        fi.load_schedule(faults)
    srv.tracer.clear()
    reqs, steps = [], []
    script = script or {}
    step = 0
    while step < max_steps:
        for act in script.get(step, ()):
            if act[0] == "submit":
                reqs.append(srv.submit(act[1], **act[2]))
            elif act[0] == "preempt":
                srv.preempt(reqs[act[1]].request_id)
            else:
                srv.cancel(reqs[act[1]].request_id)
        if step > max(script, default=0) and not (srv.pending
                                                  or srv.live_count):
            break
        err = None
        try:
            srv.step()
        except res.InjectedFault as e:
            err = e.point
        evs = srv.tracer.events()
        srv.tracer.clear()
        steps.append((step, err,
                       srv._load.state.name if srv._load is not None
                       else None,
                       [e["name"] for e in evs if e["ph"] in ("X", "i")
                        and e["name"] != "telemetry/recompile"]))
        clock.t += TICK
        step += 1
    out = held(srv, reqs, dump_dir)
    out["steps"] = steps
    return out, srv, reqs


def held(srv, reqs, dump_dir=None):
    """What the tests hold between the packages."""
    counters = {m.name: m.value for m in srv.registry.metrics()
                if type(m).__name__ == "Counter"
                and not m.name.startswith("telemetry/")}
    dumps = ([sorted(json.load(open(f)))
              for f in sorted(glob.glob(f"{dump_dir}/*.json"))]
             if dump_dir is not None else [])
    return {
        "reqs": [(r.request_id, r.state.value,
                  None if r.finish_reason is None else str(r.finish_reason),
                  None if r.reject_reason is None else str(r.reject_reason),
                  list(r.output_tokens), r.preemptions, r.retry_after_s,
                  r.priority_class) for r in reqs],
        "timelines": {r.request_id: srv.timelines.events_of(r.request_id)
                      for r in reqs},
        "counters": counters,
        "dumps": dumps,
    }


def assert_same(want, got, label):
    for key in ("reqs", "timelines", "counters", "dumps"):
        assert got[key] == want[key], f"{label}: {key} differ"
    if "steps" in want:
        for a, b in zip(want["steps"], got["steps"]):
            assert b == a, f"{label}: step {a[0]} differs"
        assert len(got["steps"]) == len(want["steps"])


def assert_clean(srv):
    """The post-fault contract: bookkeeping consistent, no leaked slot or
    page, every timeline terminal."""
    srv.check_invariants()
    assert srv.pool.free_count == srv.pool.num_slots and srv.live_count == 0
    assert srv.timelines.open_ids() == []
    if srv._paged:
        held_pages = (len(srv.pool.prefix.page_counts())
                      if srv.pool.prefix is not None else 0)
        assert srv.pool.free_page_count + held_pages == srv.pool.num_pages


# ---------------------------------------------------------------------------
# engine scenarios, held against the JAX engine
# ---------------------------------------------------------------------------
def _generated(stack, req):
    return stack["port"].generate(req.prompt[None],
                                  max_new_tokens=req.max_new_tokens)[0]


def _chaos():
    """The six-point chaos drill's serving half (state corruption has its
    own test): admit_oom, nan_logits, step_host_error and slow_dispatch
    against the step wall budget, after a warm-up, with the guard and the
    SLO tracker on."""
    warm = [[(p, 3)] for p in _prompts(1, [6])] + \
        [[(p, 3) for p in _prompts(2, [7, 8])]]
    prompts = _prompts(3, [5, 9, 12, 6, 14, 8])
    script = {0: [("submit", p, dict(max_new_tokens=6)) for p in prompts]}
    cfg = dict(num_slots=2, max_queue_depth=16, prefill_chunk=CHUNK,
               guard_numerics=True, step_wall_budget_ms=10.0, slo=True)
    faults = {"admit_oom": [2], "nan_logits": [3], "step_host_error": [7],
              "slow_dispatch": [4]}
    return dict(cfg=cfg, script=script, faults=faults, warm=warm)


def _chaos_checks(stack, out, srv, reqs):
    assert srv.watchdog.recompiles == 0          # no fault adds a program
    states = [r.state for r in reqs]
    assert RequestState.FAILED in states and RequestState.FINISHED in states
    failed = {str(r.finish_reason) for r in reqs
              if r.state is RequestState.FAILED}
    assert failed == {"numerical_error", "error"}
    assert sum(r.finish_reason == "numerical_error" for r in reqs) == 1
    assert srv.stats()["step_overruns"] == 1
    faults = [s[1] for s in out["steps"] if s[1] is not None]
    assert faults == ["admit_oom", "step_host_error"]
    # the survivors' tokens are generate()'s
    for r in reqs:
        if r.state is RequestState.FINISHED and r.preemptions == 0:
            np.testing.assert_array_equal(r.tokens(), _generated(stack, r))


def _deadlines():
    """Per-request deadlines (a queued request expires before a prefill,
    a seated one through its slot), the prompt-too-long and queue-full
    rejections, manual preemption of a PREFILLING request mid-chunk and of
    a RUNNING one, and cancels of a queued and a seated request."""
    a, b, c, d, e, f, g, h, i = _prompts(4, [40, 5, 9, 20, 70, 6, 6, 7, 12])
    script = {
        0: [("submit", a, dict(max_new_tokens=6)),
            ("submit", b, dict(max_new_tokens=8, deadline_ms=35.0)),
            ("submit", c, dict(max_new_tokens=8)),
            ("submit", d, dict(max_new_tokens=4, deadline_ms=20.0)),
            ("submit", e, dict(max_new_tokens=4)),       # too long
            ("submit", f, dict(max_new_tokens=3)),
            ("submit", g, dict(max_new_tokens=3))],      # queue full
        1: [("preempt", 0)],                             # mid-chunk
        3: [("cancel", 2)],                              # queued
        4: [("submit", h, dict(max_new_tokens=5)),
            ("submit", i, dict(max_new_tokens=5, deadline_ms=1000.0))],
        5: [("cancel", 5)],                              # seated
        8: [("preempt", 7)],                             # running
    }
    cfg = dict(num_slots=2, max_queue_depth=5, prefill_chunk=CHUNK,
               prefill_token_budget=CHUNK,
               slo={"ttft_ms": 60000.0, "gap_ms": 60000.0,
                    "window_steps": 8})
    return dict(cfg=cfg, script=script)


def _deadlines_checks(stack, out, srv, reqs):
    reasons = [str(r.finish_reason or r.reject_reason) for r in reqs]
    assert reasons.count("deadline") == 2
    assert reasons.count("cancelled") == 2
    assert "prompt_too_long" in reasons and "queue_full" in reasons
    assert reqs[0].preemptions == 1 and reqs[7].preemptions == 1
    tl = out["timelines"][0]
    assert tl.index("preempted") < tl.index("first_token")  # mid-chunk
    st = srv.stats()
    assert st["deadline_expired"] == 2 and st["cancelled"] == 2
    # a cancellation is goodput-neutral, a deadline counts against it
    snap = srv.slo.snapshot()
    assert snap["cancelled"] == 2 and snap["admitted"] == 5
    assert snap["good"] == 3
    for r in reqs:
        if r.finish_reason == "length":       # preempted ones included
            np.testing.assert_array_equal(r.tokens(), _generated(stack, r))


def _degrade():
    """The HEALTHY/PRESSURED/OVERLOADED ladder walked up and back down,
    overload shedding with retry_after, automatic preemption past the
    queue threshold (lowest class first) under priority classes; then
    burn-rate class shedding: the interactive class misses its TTFT
    target on the fake clock, its alert pages, and lower classes are shed
    at submit (retry_after) and preempted while an interactive request
    waits."""
    prompts = _prompts(5, [5, 9, 20, 40, 7, 12, 6, 30])
    classes = ["batch", "standard", "interactive", "batch", "standard",
               "interactive"]
    late = _prompts(6, [5, 9, 20, 40, 7, 12])
    late_classes = ["interactive", "batch", "standard", "interactive",
                    "batch", "standard"]
    script = {0: [("submit", p, dict(max_new_tokens=4, priority=c))
                  for p, c in zip(prompts, classes)],
              1: [("submit", prompts[6], dict(max_new_tokens=4))],
              5: [("submit", prompts[7], dict(max_new_tokens=4,
                                               priority="interactive"))],
              16: [("submit", p, dict(max_new_tokens=5, priority=c))
                   for p, c in zip(late[:3], late_classes[:3])],
              18: [("submit", p, dict(max_new_tokens=5, priority=c))
                   for p, c in zip(late[3:], late_classes[3:])]}
    cfg = dict(num_slots=2, max_queue_depth=32, prefill_chunk=CHUNK,
               preempt_queue_threshold=2, preempt_min_run_steps=2,
               priority=True,
               degradation={"queue_pressured": 2, "queue_overloaded": 4,
                            "cooldown_steps": 2, "retry_after_s": 0.25},
               slo={"classes": {"interactive": {"ttft_ms": 15.0,
                                                "gap_ms": None}},
                    "window_steps": 2, "windows": 2, "warn_burn": 1.5,
                    "page_burn": 3.0})
    return dict(cfg=cfg, script=script)


def _degrade_checks(stack, out, srv, reqs):
    levels = [s[2] for s in out["steps"]]
    assert levels[0] == "OVERLOADED" and levels[-1] == "HEALTHY"
    assert "PRESSURED" in levels
    shed = [r for r in reqs if r.state is RequestState.REJECTED]
    assert all(r.retry_after_s == 0.25 for r in shed)
    assert [r.request_id for r in shed[:2]] == [6, 7]    # overload
    # burn shedding: the lower classes refused at step 18, the ladder
    # below OVERLOADED, while the interactive arrivals are admitted
    late = reqs[8:]
    burned = [r for r in late if r.state is RequestState.REJECTED]
    assert levels[17] != "OVERLOADED" and len(burned) == 2
    assert all(r.priority_class != "interactive" for r in burned)
    assert all(r.state is RequestState.FINISHED for r in late
               if r.priority_class == "interactive")
    assert srv.stats()["preempted"] >= 1 and srv.stats()["load_transitions"] \
        >= 2
    for r in reqs:
        if r.state is RequestState.FINISHED:
            np.testing.assert_array_equal(r.tokens(), _generated(stack, r))


def _spec():
    """Degradation with speculative decoding: OVERLOADED suspends drafting
    (zero-length drafts through the same verify forward) and the greedy
    tokens stay generate()'s; drafting again, drafter_error aborts a step
    (its running requests FAILED, reason error), then admit_oom rolls an
    admission back, and the server serves on."""
    prompts = [np.tile(p[:4], 4) for p in _prompts(7, [5, 6, 7, 8, 9, 6])]
    script = {0: [("submit", p, dict(max_new_tokens=8))
                  for p in prompts[:4]],
              14: [("submit", p, dict(max_new_tokens=8))
                   for p in prompts[4:]]}
    cfg = dict(num_slots=2, max_queue_depth=16, prefill_chunk=CHUNK,
               spec_decode={"drafter": "ngram", "k": 4}, guard_numerics=True,
               degradation={"queue_pressured": 1, "queue_overloaded": 2,
                            "cooldown_steps": 3})
    return dict(cfg=cfg, script=script,
                faults={"admit_oom": [5], "drafter_error": [2]})


def _spec_checks(stack, out, srv, reqs):
    levels = [s[2] for s in out["steps"]]
    overloaded = [i for i, lv in enumerate(levels) if lv == "OVERLOADED"]
    assert overloaded and levels[-1] == "HEALTHY"
    # no draft span while overloaded, drafting again after
    assert not any("serving/draft" in out["steps"][i][3] for i in overloaded)
    assert any("serving/draft" in s[3] for s in out["steps"])
    assert srv.stats()["spec_drafted"] > 0
    faults = [s[1] for s in out["steps"] if s[1] is not None]
    assert faults == ["drafter_error", "admit_oom"]
    assert srv.stats()["failed_reasons"] == {"error": 2}
    finished = [r for r in reqs if r.state is RequestState.FINISHED]
    assert len(finished) == 4
    for r in finished:
        np.testing.assert_array_equal(r.tokens(), _generated(stack, r))


def _overlap():
    """The pipelined step under faults: a NaN row failed in the drain, a
    seated deadline expiring, a seated cancel, and (paged: a 3-page pool)
    page-pressure preemption of a request whose decode was already
    dispatched."""
    prompts = _prompts(9, [12, 20, 9, 14, 30])
    script = {0: [("submit", prompts[0], dict(max_new_tokens=10)),
                  ("submit", prompts[1],
                   dict(max_new_tokens=10, deadline_ms=60.0)),
                  ("submit", prompts[2], dict(max_new_tokens=10)),
                  ("submit", prompts[3], dict(max_new_tokens=10))],
              3: [("cancel", 0)],
              4: [("submit", prompts[4], dict(max_new_tokens=6))]}
    cfg = dict(num_slots=2, max_queue_depth=16, prefill_chunk=CHUNK,
               overlap=True, guard_numerics=True)
    return dict(cfg=cfg, script=script, faults={"nan_logits": [9]},
                paged_extra={"num_pages": 3, "prefix_cache": False})


def _overlap_checks(stack, out, srv, reqs):
    reasons = [str(r.finish_reason) for r in reqs]
    assert reasons.count("numerical_error") == 1
    assert "deadline" in reasons and "cancelled" in reasons
    if srv._paged:
        assert srv.stats()["preempted"] >= 1
    for r in reqs:
        if r.finish_reason == "length":
            np.testing.assert_array_equal(r.tokens(), _generated(stack, r))


SCENARIOS = {"chaos": (_chaos, _chaos_checks),
             "deadlines": (_deadlines, _deadlines_checks),
             "degrade": (_degrade, _degrade_checks),
             "spec": (_spec, _spec_checks),
             "overlap": (_overlap, _overlap_checks)}


@pytest.mark.parametrize("pool", POOLS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(stack, name, pool):
    make, checks = SCENARIOS[name]
    sc = make()
    cfg = sc.pop("cfg")
    want, _, _ = serve(stack, "jax", pool, cfg, **sc)
    for side in ("port", "port_graph"):
        got, srv, reqs = serve(stack, side, pool, cfg, **sc)
        assert_same(want, got, f"{name}/{pool}/{side}")
        assert_clean(srv)
        checks(stack, got, srv, reqs)


def test_overlap_drops_the_token_of_a_slot_lost_before_the_fetch(stack):
    """A request that fails between the pipelined dispatch and the fetch
    drops its deferred token: it is not appended, its slot is released
    once, and every page returns."""
    srv = dst.ServingEngine(stack["port"], num_slots=2, prefill_chunk=CHUNK,
                            overlap=True, guard_numerics=True,
                            paged_kv={"page_size": PS},
                            fault_injector=FaultInjector(
                                seed=0, schedule={"nan_logits": [3]}))
    reqs = [srv.submit(p, max_new_tokens=8) for p in _prompts(11, [6, 9])]
    while srv.pending or srv.live_count:
        before = {r.request_id: len(r.output_tokens) for r in reqs}
        srv.step()
        srv.check_invariants()
        for r in reqs:
            if r.state is RequestState.FAILED:
                # the poisoned step's token never reached the request
                assert len(r.output_tokens) == before[r.request_id]
    (bad,) = [r for r in reqs if r.state is RequestState.FAILED]
    assert bad.finish_reason is FinishReason.NUMERICAL_ERROR
    assert_clean(srv)


@pytest.mark.parametrize("pool", POOLS)
def test_state_corruption_writes_one_post_mortem(stack, pool, tmp_path):
    """The sixth chaos point: the engine corrupts its own slot bookkeeping
    at the step boundary; check_invariants raises and writes exactly one
    post-mortem, whose keys (POST_MORTEM_KEYS) and reason equal the JAX
    engine's."""
    prompts = _prompts(12, [6, 9])
    out = {}
    for side in ("jax", "port"):
        mod, res, tel = SIDES[side]
        clock = FakeClock()
        kw = dict(num_slots=2, max_queue_depth=8, prefill_chunk=CHUNK,
                  clock=clock, dump_dir=str(tmp_path / side),
                  fault_injector=res.FaultInjector(seed=0))
        if pool == "paged":
            kw["paged_kv"] = {"page_size": PS,
                              **({"kernel": "off"} if side == "jax" else {})}
        srv = mod.ServingEngine(stack[side], **kw)
        srv.faults.load_schedule({"state_corruption": [1]})
        for p in prompts:
            srv.submit(p, max_new_tokens=4)
        srv.step()
        with pytest.raises(AssertionError) as info:
            srv.check_invariants()
        assert type(info.value).__name__ == "InvariantViolation"
        (path,) = glob.glob(str(tmp_path / side / "postmortem-*.json"))
        with open(path) as f:
            out[side] = json.load(f)
        assert srv.recorder.dump_count == 1
    pm, want = out["port"], out["jax"]
    assert sorted(pm) == sorted(want) == sorted(pt.POST_MORTEM_KEYS)
    assert pm["reason"] == want["reason"] == "invariant_violation"
    assert pm["schema_version"] == want["schema_version"]
    assert "free" in pm["error"] and pm["extra"]["violations"]
    last = pm["steps"][-1]
    assert sorted(last) == sorted(want["steps"][-1])
    assert last["step_id"] == 1 and last["live"] == 2
    assert pm["extra"] == want["extra"]


@pytest.mark.parametrize("pool", POOLS)
def test_stall_guard_raises_with_dump_and_post_mortem(stack, pool, tmp_path):
    """Queued work that can never be granted is the livelock the guard
    catches: ServingStalledError with the stuck requests' dump, and a
    'stalled' post-mortem, as in the JAX engine (a contiguous one on both
    pools: the dump and the post-mortem's keys and extra do not depend on
    the pool, and a JAX paged server compiles its own programs); max_steps
    still caps a drain without raising."""
    out = {}
    for side in ("jax", "port"):
        mod, res, _ = SIDES[side]
        kw = dict(num_slots=2, max_queue_depth=8,
                  dump_dir=str(tmp_path / side))
        if pool == "paged" and side == "port":
            kw["paged_kv"] = {"page_size": PS}
        srv = mod.ServingEngine(stack[side], **kw)
        req = srv.submit(np.arange(6, dtype=np.int32), max_new_tokens=4)
        srv.scheduler.grant = lambda *a, **k: []
        with pytest.raises(res.ServingStalledError) as info:
            srv.run_until_drained(stall_patience=5)
        dump = info.value.dump
        assert [d["request_id"] for d in dump] == [req.request_id]
        assert dump[0]["state"] == "queued" and "no progress" in \
            str(info.value)
        (path,) = glob.glob(str(tmp_path / side / "postmortem-*.json"))
        with open(path) as f:
            out[side] = json.load(f)
        out[side + "_dump"] = dump
    free = dst.ServingEngine(stack["port"], **{**kw, "dump_dir": None})
    free.submit(np.arange(6, dtype=np.int32), max_new_tokens=50)
    assert isinstance(free.run_until_drained(max_steps=3), list)
    assert free.live_count == 1
    assert out["port_dump"] == out["jax_dump"]
    assert sorted(out["port"]) == sorted(out["jax"])
    assert out["port"]["reason"] == out["jax"]["reason"] == "stalled"
    assert out["port"]["extra"] == out["jax"]["extra"]


def test_preempt_unknown_id_raises_and_manual_preempt_goes_first(stack):
    srv = dst.ServingEngine(stack["port"], num_slots=1, max_queue_depth=8)
    with pytest.raises(ValueError, match="not seated"):
        srv.preempt(12345)
    victim, waiter = (srv.submit(p, max_new_tokens=n)
                      for p, n in zip(_prompts(13, [5, 5]), (16, 4)))
    srv.step()
    assert victim.state is RequestState.RUNNING
    srv.preempt(victim.request_id)
    assert victim.state is RequestState.QUEUED and victim.slot is None
    assert [r.request_id for r in srv.scheduler.queue] == \
        [victim.request_id, waiter.request_id]
    assert srv.cancel(999) is None


def test_pressure_shrinks_prefill_budget(stack):
    srv = dst.ServingEngine(stack["port"], num_slots=2, prefill_chunk=16,
                            prefill_token_budget=64,
                            degradation={"queue_pressured": 1,
                                         "queue_overloaded": 8})
    assert srv._effective_prefill_budget() == 64
    srv._load.state = LoadState.PRESSURED
    assert srv._effective_prefill_budget() == 32
    srv._load.state = LoadState.OVERLOADED
    assert srv._effective_prefill_budget() == 16   # one chunk


@pytest.mark.parametrize("key,val,match", [
    ("deadline_default_ms", 0, "deadline_default_ms must be > 0"),
    ("step_wall_budget_ms", -1.0, "step_wall_budget_ms must be > 0"),
    ("preempt_queue_threshold", 0, "preempt_queue_threshold must be >= 1"),
    ("degradation", {"nope": 1}, "unknown degradation keys"),
])
def test_constructor_validation_matches_jax(stack, key, val, match):
    for side in ("jax", "port"):
        mod = SIDES[side][0]
        with pytest.raises(ValueError, match=match):
            mod.ServingEngine(stack[side], num_slots=2, **{key: val})
    srv = dst.ServingEngine(stack["port"], num_slots=2, priority=True)
    with pytest.raises(ValueError, match="unknown priority class"):
        srv.submit(np.arange(4, dtype=np.int32), priority="gold")
    plain = dst.ServingEngine(stack["port"], num_slots=2)
    with pytest.raises(ValueError, match="priority-enabled"):
        plain.submit(np.arange(4, dtype=np.int32), priority="batch")
    with pytest.raises(ValueError, match="deadline_ms must be > 0"):
        plain.submit(np.arange(4, dtype=np.int32), deadline_ms=0)


# ---------------------------------------------------------------------------
# the pieces, without a model
# ---------------------------------------------------------------------------
class TestFaultInjector:
    def test_schedule_fires_exact_ordinals(self):
        fi = FaultInjector(seed=0, schedule={"admit_oom": [2, 4]})
        fired = []
        for _ in range(5):
            try:
                fi.check("admit_oom")
                fired.append(False)
            except InjectedFault as e:
                assert e.point == "admit_oom"
                fired.append(True)
        assert fired == [False, True, False, True, False]
        assert fi.counts["admit_oom"] == 5 and fi.fired["admit_oom"] == 2

    @pytest.mark.parametrize("kwargs,match", [
        (dict(schedule={"admit_oom": [0]}), "1-based"),
        (dict(schedule={"disk_full": [1]}), "unknown injection point"),
        (dict(rates={"nan_logits": 1.5}), "must be in"),
        (dict(slow_ms=-1.0), "slow_ms"),
    ])
    def test_validation_matches_jax(self, kwargs, match):
        for mod in (jr, pr):
            with pytest.raises(ValueError, match=match):
                mod.FaultInjector(**kwargs)
        with pytest.raises(ValueError, match="unknown injection point"):
            FaultInjector().check("disk_full")

    @pytest.mark.parametrize("point", pr.POINTS)
    def test_rate_streams_match_jax(self, point):
        """Seeded per-point streams: replayable, seed-dependent, per point,
        and draw for draw the JAX injector's."""
        def pattern(mod, seed, pt_, n=64):
            fi = mod.FaultInjector(seed=seed, rates={pt_: 0.5})
            return [fi._roll(pt_) for _ in range(n)]

        a = pattern(pr, 7, point)
        assert a == pattern(pr, 7, point) == pattern(jr, 7, point)
        assert a != pattern(pr, 8, point)
        other = "drafter_error" if point != "drafter_error" else "nan_logits"
        assert a != pattern(pr, 7, other)

    def test_load_schedule_resets_counts_and_sleep_fires_on_schedule(self):
        fi = FaultInjector(schedule={"admit_oom": [1]})
        with pytest.raises(InjectedFault):
            fi.check("admit_oom")
        fi.load_schedule({"admit_oom": [1]})
        assert fi.counts["admit_oom"] == 0
        with pytest.raises(InjectedFault):
            fi.check("admit_oom")
        fi = FaultInjector(schedule={"slow_dispatch": [2]}, slow_ms=0.0)
        assert fi.maybe_sleep() is False and fi.maybe_sleep() is True

    def test_corrupt_logits_poisons_the_jax_row_in_place(self):
        """The same seed poisons the same live row as the JAX injector,
        in place on the tensor (no copy, no new shape)."""
        logits = torch.randn(4, 1, 8)
        jlog = jnp.asarray(logits.numpy())
        rows = [3, 0, 2]
        for n in range(1, 4):
            fi = FaultInjector(seed=n, schedule={"nan_logits": [1]})
            jfi = jr.FaultInjector(seed=n, schedule={"nan_logits": [1]})
            t = logits.clone()
            got, slot = fi.corrupt_logits(t, rows)
            jgot, jslot = jfi.corrupt_logits(jlog, rows)
            assert got is t and slot == jslot
            np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
            assert torch.isnan(got[slot]).all()
            assert torch.isfinite(got[[r for r in range(4)
                                       if r != slot]]).all()
        assert fi.corrupt_logits(logits, rows) == (logits, None)
        assert FaultInjector(schedule={"nan_logits": [1]}).corrupt_logits(
            logits, []) == (logits, None)

    def test_drafter_wrapper_raises_where_a_drafter_would(self):
        class Inner:
            name = "inner"

            def propose(self, histories, k):
                return np.zeros((len(histories), k)), np.zeros(len(histories))

        w = pr.FaultInjectingDrafter(Inner(), FaultInjector(
            schedule={"drafter_error": [2]}))
        assert w.name == "inner"
        w.propose([None], 2)
        with pytest.raises(InjectedFault, match="drafter_error"):
            w.propose([None], 2)


class TestReasonEnums:
    def test_enums_match_jax(self):
        for port, jax_ in ((FinishReason, js.FinishReason),
                           (RejectReason, js.RejectReason)):
            assert [(m.name, m.value) for m in port] == \
                [(m.name, m.value) for m in jax_]
        assert FinishReason.DEADLINE == "deadline"
        assert str(FinishReason.NUMERICAL_ERROR) == "numerical_error"
        assert f"{FinishReason.EOS}" == "eos"
        assert FinishReason.of("length") is FinishReason.LENGTH
        assert RejectReason.of("retry_after") is RejectReason.RETRY_AFTER
        with pytest.raises(ValueError):
            FinishReason.of("melted")
        with pytest.raises(ValueError):
            RejectReason.of("because")

    def test_request_fields_match_jax(self):
        import dataclasses
        port = {f.name for f in dataclasses.fields(Request)}
        jax_ = {f.name for f in dataclasses.fields(js.Request)}
        assert jax_ - port == {"journey_id", "hop"}     # the router's
        assert port <= jax_
        r = Request(0, np.arange(4, dtype=np.int32), 4)
        assert (r.priority_class, r.tenant, r.deadline_ms) == \
            ("default", "default", None)
        r.deadline_time = 5.0
        assert not r.expired(4.9) and r.expired(5.0)

    @pytest.mark.parametrize("Metrics", [ServingMetrics, JaxMetrics])
    def test_metrics_reject_unknown_reasons(self, Metrics):
        m = Metrics(None)
        req = Request(0, np.arange(4, dtype=np.int32), 4, None)
        req.reject_reason = "bogus"
        with pytest.raises(ValueError):
            m.record_rejection(req)
        req.reject_reason = RejectReason.QUEUE_FULL
        m.record_rejection(req)
        bad = Request(1, np.arange(4, dtype=np.int32), 4, None)
        bad.finish_reason = "imploded"
        with pytest.raises(ValueError):
            m.record_failure(bad)


class TestSchedulerResilience:
    @staticmethod
    def _req(i, out=0):
        r = Request(i, np.arange(4, dtype=np.int32), 8, None)
        r.output_tokens = list(range(out))
        return r

    def test_requeue_front_preserves_relative_order(self):
        s = FIFOScheduler(2, max_queue_depth=8)
        a, b, c = (self._req(i) for i in range(3))
        s.submit(c)
        s.requeue_front([a, b])
        assert [r.request_id for r in s.queue] == [0, 1, 2]
        assert all(r.state is RequestState.QUEUED for r in (a, b))
        s.requeue_back([self._req(3)])
        assert [r.request_id for r in s.queue] == [0, 1, 2, 3]
        assert s.head() is a

    def test_expire_removes_only_expired(self):
        s = FIFOScheduler(2, max_queue_depth=8)
        a, b = self._req(0), self._req(1)
        a.deadline_time, b.deadline_time = 10.0, 30.0
        s.submit(a)
        s.submit(b)
        assert s.expire(now=20.0) == [a]
        assert list(s.queue) == [b] and s.head() is b
        assert FIFOScheduler(1).head() is None

    def test_capacity_accounts_resumed_seed(self):
        s = FIFOScheduler(2, max_queue_depth=8, capacity=16)
        r = self._req(0, out=10)
        r.max_new_tokens = 12
        assert s.submit(r) == (True, None)
        r2 = self._req(1, out=10)
        r2.max_new_tokens = 13
        ok, why = s.submit(r2)
        assert not ok and why is RejectReason.PROMPT_TOO_LONG

    def test_priority_scheduler_matches_jax(self):
        """Fair-share grants, head(), tenant quota and rate limits, on the
        same injected clock, against the JAX PriorityScheduler."""
        from deepspeed_tpu.serving.frontend.priority import \
            PriorityScheduler as JaxPriority
        cfg = {"shares": {"interactive": 2.0},
               "tenants": {"*": {"max_queued": 3},
                           "slow": {"tokens_per_s": 10.0}}}
        classes = ["batch", "interactive", "standard", "interactive",
                   "batch", "standard", "interactive", "batch"]
        tenants = ["a", "b", "a", "slow", "slow", "a", "b", "a"]
        out = []
        for Sched, Req in ((ps.PriorityScheduler, Request),
                           (JaxPriority, js.Request)):
            t = [0.0]
            s = Sched(4, max_queue_depth=16, priority=cfg,
                      clock=lambda: t[0])
            got = []
            for i, (c, ten) in enumerate(zip(classes, tenants)):
                r = Req(i, np.arange(4 + i, dtype=np.int32), 6)
                r.priority_class, r.tenant = c, ten
                ok, why = s.submit(r)
                got.append((ok, None if why is None else why.value,
                            r.retry_after_s))
                t[0] += 0.05
            got.append(s.head().request_id)
            got.append(s.class_depths())
            got.append([r.request_id for r in s.grant(
                3, 0, token_budget=24, cost=lambda r: r.prompt_len)])
            got.append(s.head_within(1) and s.head_within(1).request_id)
            out.append(got)
        assert out[0] == out[1]


class TestVictimSelection:
    @staticmethod
    def _seated(i, tokens, admit_step, cls="batch"):
        r = Request(i, np.arange(4, dtype=np.int32), 32, None)
        r.state = RequestState.RUNNING
        r.output_tokens = list(range(tokens))
        r.last_admit_step = admit_step
        r.priority_class = cls
        return r

    def test_youngest_lowest_progress_first(self):
        old = self._seated(0, tokens=9, admit_step=0)
        young = self._seated(1, tokens=2, admit_step=3)
        younger = self._seated(2, tokens=2, admit_step=5)
        got = select_victims([old, young, younger], n=2, current_step=20)
        assert [r.request_id for r in got] == [2, 1]

    def test_min_run_steps_protects_fresh_seats(self):
        fresh = self._seated(0, tokens=0, admit_step=9)
        settled = self._seated(1, tokens=5, admit_step=0)
        assert select_victims([fresh, settled], n=2, current_step=10,
                              min_run_steps=2) == [settled]
        q = self._seated(2, tokens=0, admit_step=0)
        q.state = RequestState.QUEUED
        assert select_victims([q], current_step=10) == []

    def test_class_rank_dominates_and_matches_jax(self):
        rank = {"interactive": 0, "standard": 1, "batch": 2}.get
        seats = [(1, 5, "interactive"), (9, 0, "batch"), (4, 2, "standard"),
                 (9, 1, "batch"), (0, 3, "interactive")]
        reqs = [self._seated(i, tokens=t, admit_step=s, cls=c)
                for i, (t, s, c) in enumerate(seats)]
        jreqs = []
        for r in reqs:
            j = js.Request(r.request_id, r.prompt, 32)
            j.state, j.output_tokens = js.RequestState.RUNNING, \
                r.output_tokens
            j.last_admit_step, j.priority_class = r.last_admit_step, \
                r.priority_class
            jreqs.append(j)
        got = select_victims(reqs, n=5, current_step=20,
                             class_rank=lambda r: rank(r.priority_class))
        want = jax_select_victims(jreqs, n=5, current_step=20,
                                  class_rank=lambda r: rank(
                                      r.priority_class))
        assert len(got) == 5
        assert [r.request_id for r in got] == [r.request_id for r in want]
        assert got[0].priority_class == "batch"
        assert got[-1].priority_class == "interactive"


class TestLoadStateMachine:
    def test_escalates_immediately_deescalates_after_cooldown(self):
        cfg = DegradationConfig.from_value(
            {"queue_pressured": 2, "queue_overloaded": 4,
             "cooldown_steps": 3})
        m = LoadStateMachine(cfg)
        assert m.update(4, None, step=0) == (LoadState.HEALTHY,
                                             LoadState.OVERLOADED)
        assert m.update(0, None, step=1) is None
        assert m.update(0, None, step=2) is None
        assert m.update(0, None, step=3) == (LoadState.OVERLOADED,
                                             LoadState.HEALTHY)

    def test_ladder_matches_jax_on_a_signal_trace(self):
        kw = {"queue_pressured": 3, "queue_overloaded": 6,
              "gap_p99_pressured_ms": 5.0, "gap_p99_overloaded_ms": 50.0,
              "cooldown_steps": 2}
        m = LoadStateMachine(DegradationConfig.from_value(kw))
        jm = JaxLoadStateMachine(jr.DegradationConfig.from_value(kw))
        rng = np.random.default_rng(0)
        for step in range(200):
            q = int(rng.integers(0, 9))
            gap = None if step % 7 == 0 else float(rng.uniform(0, 80))
            got, want = m.update(q, gap, step), jm.update(q, gap, step)
            assert (None if got is None else tuple(map(int, got))) == \
                (None if want is None else tuple(map(int, want)))
            assert int(m.state) == int(jm.state)
        assert len(m.transitions) == len(jm.transitions) > 10

    @pytest.mark.parametrize("value", [
        {"queue_pressured": 9, "queue_overloaded": 4},
        {"nope": 1},
        {"queue_pressured": None, "queue_overloaded": None},
        {"queue_pressured": 2, "queue_overloaded": None},
        {"window": 0},
        {"retry_after_s": -1.0},
        "yes",
    ])
    def test_config_validation_matches_jax(self, value):
        errors = []
        for mod in (pr, jr):
            with pytest.raises((ValueError, TypeError)) as info:
                mod.DegradationConfig.from_value(value)
            errors.append((type(info.value), str(info.value)))
        assert errors[0] == errors[1]
        assert DegradationConfig.from_value(None) is None
        assert DegradationConfig.from_value(True).queue_pressured == 8
