"""Serving telemetry of the port on the CPU: the scenarios of the JAX
``tests/unit/telemetry/test_telemetry.py`` and ``test_efficiency.py`` and
of ``tests/unit/serving/test_telemetry_serving.py`` and
``test_observability_serving.py`` that need neither the cost model nor the
fleet.

The telemetry modules are copies of the JAX package's (they import no
JAX), so each is held against its JAX twin on the same inputs: tracer
events and Chrome exports, registry snapshots and Prometheus text,
timelines, SLO digests, windows, goodput and burn alerts, flight-recorder
rings and post-mortems, watchdog sinks. The serving engine's telemetry
runs on the contiguous and the paged pool over a tiny port model with
seeded random weights; its step spans, timelines and registry counters
are held against the JAX engine's in ``tests/test_torch_resilience.py``.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu.telemetry as jt
from deepspeed_tpu.telemetry import flight_recorder as jfr
from deepspeed_tpu.telemetry import slo as jslo
import deepspeed_tpu_torch as dst
import deepspeed_tpu_torch.telemetry as pt
from deepspeed_tpu_torch.models import transformer_lm as P
from deepspeed_tpu_torch.serving import (InvariantViolation, RequestState,
                                         ServingEngine)
from deepspeed_tpu_torch.serving.resilience import FaultInjector
from deepspeed_tpu_torch.telemetry import (POST_MORTEM_KEYS, FlightRecorder,
                                           MetricsRegistry,
                                           RecompileAfterWarmupError,
                                           RecompileWatchdog, SLOConfig,
                                           SLOTargets, SLOTracker,
                                           TimelineStore, Tracer,
                                           QuantileDigest, WindowedQuantiles)
from deepspeed_tpu_torch.telemetry.flight_recorder import SCHEMA_VERSION

PS = CHUNK = 16
POOLS = {"contiguous": False, "paged": {"page_size": PS}}
BOTH = (jt, pt)


class _FakeMonitor:
    enabled = True

    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


def _untimed(events):
    """Tracer events without their host times and thread ids."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid")}
            for e in events]


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------
def _tracer_ops(tel):
    tr = tel.Tracer(capacity=64, process_name="test-proc")
    with tr.span("outer", step=1) as sp:
        sp.set(extra=3)
        with tr.span("inner"):
            pass
    try:
        with tr.span("boom"):
            raise ValueError("nope")
    except ValueError:
        pass
    tr.counter("slots", live=2)
    tr.instant("tick", n=1)
    tr.async_begin("request", "req-1", 1, event="submitted")
    tr.async_instant("request", "first_token", 1)
    tr.async_end("request", "req-1", 1)
    tr.flow("s", "req", 1)
    tr.flow("f", "req", 1)

    @tr.trace("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    return tr


def test_tracer_events_and_chrome_export_match_jax(tmp_path):
    trs = [_tracer_ops(tel) for tel in BOTH]
    assert _untimed(trs[0].events()) == _untimed(trs[1].events())
    docs = []
    for tr, side in zip(trs, ("jax", "port")):
        path = tmp_path / f"{side}.json"
        n = tr.export(str(path))
        doc = json.loads(path.read_text())
        assert n == len(doc["traceEvents"])
        docs.append(doc)
    for a, b in zip(*(d["traceEvents"] for d in docs)):
        assert {k: v for k, v in a.items() if k not in ("ts", "dur")} == \
            {k: v for k, v in b.items() if k not in ("ts", "dur")}
    pdoc = docs[1]
    phs = {e["ph"] for e in pdoc["traceEvents"]}
    assert {"X", "C", "b", "n", "e", "s", "f", "i", "M"} <= phs
    assert all(e["ts"] >= 0 for e in pdoc["traceEvents"] if e["ph"] != "M")
    assert all(e["bp"] == "e" for e in pdoc["traceEvents"] if e["ph"] == "f")
    (boom,) = [e for e in trs[1].events() if e["name"] == "boom"]
    assert boom["args"]["error"] == "ValueError"
    (outer,) = [e for e in trs[1].events() if e["name"] == "outer"]
    assert outer["args"] == {"step": 1, "extra": 3} and outer["dur"] >= 0
    assert pdoc["otherData"]["events_total"] == trs[1].events_total
    merged = pt.merge_chrome([("a", trs[1]), ("b", _tracer_ops(pt))])
    assert merged["otherData"]["processes"] == {"0": "a", "1": "b"}
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}


@pytest.mark.parametrize("capacity,n", [(8, 20), (4, 10), (16, 16)])
def test_tracer_ring_wraparound_and_drops_match_jax(capacity, n, tmp_path):
    got = []
    for tel in BOTH:
        tr = tel.Tracer(capacity=capacity)
        for i in range(n):
            tr.instant(f"ev-{i}")
        evs = tr.events()
        assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
        path = tmp_path / "t.json"
        tr.export(str(path))
        got.append(([e["name"] for e in evs], tr.events_total, tr.dropped,
                    json.loads(path.read_text())["otherData"]["dropped"]))
    assert got[0] == got[1]
    names, total, dropped, exported = got[1]
    assert names == [f"ev-{i}" for i in range(max(0, n - capacity), n)]
    assert total == n and dropped == exported == max(0, n - capacity)


def test_disabled_tracer_is_null_and_clear_resets():
    tr = Tracer(enabled=False)
    with tr.span("x") as sp:
        sp.set(a=1)
    tr.instant("y")
    tr.counter("z", v=1)
    tr.async_begin("c", "n", 0)
    tr.flow("s", "f", 0)
    assert tr.events() == [] and tr.events_total == 0
    tr = Tracer(capacity=4)
    tr.instant("a")
    tr.clear()
    assert tr.events() == [] and tr.events_total == 0
    with pytest.raises(ValueError, match="capacity"):
        Tracer(capacity=0)


def test_tracer_is_thread_safe():
    tr = Tracer(capacity=100_000)
    n_threads, n_spans = 8, 200

    def worker(k):
        for i in range(n_spans):
            with tr.span(f"t{k}", i=i):
                pass
            tr.counter(f"c{k}", v=i)

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert tr.events_total == len(tr.events()) == n_threads * n_spans * 2


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def _registry_ops(tel):
    reg = tel.MetricsRegistry()
    c = reg.counter("serving/finished")
    c.inc()
    c.inc(2)
    assert reg.counter("serving/finished") is c
    g = reg.gauge("serving/live")
    g.set(5)
    g.dec(2)
    g.inc()
    h = reg.histogram("serving/ttft_ms")
    for v in (0.5, 3, 30, 30, 9999):
        h.observe(v)
    small = reg.histogram("lat_ms", buckets=(1.0, 10.0))
    for v in (0.5, 5.0, 500.0):
        small.observe(v)
    reg.add_collector(lambda: reg.gauge("pulled").set(7))
    reg.add_collector(lambda: 1 / 0)      # a broken collector is skipped
    return reg


def test_registry_snapshot_prometheus_and_publish_match_jax():
    regs = [_registry_ops(tel) for tel in BOTH]
    assert regs[0].snapshot() == regs[1].snapshot()
    text = regs[1].to_prometheus()
    assert regs[0].to_prometheus() == text
    assert "# TYPE serving_finished counter" in text
    assert "serving_finished 3" in text and "pulled 7" in text
    assert 'lat_ms_bucket{le="1"} 1' in text
    assert 'lat_ms_bucket{le="10"} 2' in text
    assert 'lat_ms_bucket{le="+Inf"} 3' in text
    assert "lat_ms_sum 505.5" in text and "lat_ms_count 3" in text
    mons = [_FakeMonitor(), _FakeMonitor()]
    ns = [reg.publish(mon, step=17) for reg, mon in zip(regs, mons)]
    assert ns[0] == ns[1] > 0 and mons[0].events == mons[1].events
    tags = [t for t, _, _ in mons[1].events]
    assert tags == sorted(tags) and all(t.startswith("telemetry/")
                                        for t in tags)
    assert regs[1].publish(None, step=1) == 0

    class _Off:
        enabled = False

    assert regs[1].publish(_Off(), step=1) == 0


def test_registry_type_conflict_and_negative_inc():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("x")
    with pytest.raises(ValueError, match="negative"):
        reg.counter("y").inc(-1)
    h = reg.histogram("h")
    h.observe(3.0)
    assert h.quantile(0.5) <= h.quantile(0.99)


# ---------------------------------------------------------------------------
# timelines
# ---------------------------------------------------------------------------
def test_timeline_store_matches_jax():
    got = []
    for tel in BOTH:
        tr = tel.Tracer()
        tl = tel.TimelineStore(capacity=2, tracer=tr)
        tl.record(1, "submitted", prompt_len=4)
        tl.record(1, "finished", terminal=True, reason="length")
        tl.record(2, "submitted")
        tl.record(2, "handoff_ready", parked=True)
        tl.record(3, "submitted")           # evicts request 1
        got.append((tl.get(1), tl.events_of(2), tl.events_of(3), len(tl),
                    tl.open_ids(), tl.parked_ids(), tl.is_open(3),
                    tl.is_open(1), tl.evicted_open,
                    _untimed(tr.events())))
    assert got[0] == got[1]
    assert got[1][:4] == (None, ["submitted", "handoff_ready"],
                          ["submitted"], 2)
    tr = Tracer()
    tl = TimelineStore(tracer=tr)
    tl.record(7, "submitted", prompt_len=4)
    tl.record(7, "first_token")
    tl.record(7, "finished", terminal=True, reason="length")
    phs = [e["ph"] for e in tr.events()]
    assert phs[0] == "b" and phs[-1] == "e" and "n" in phs
    assert tl.get(7)[0]["t_ns"] > 0
    with pytest.raises(ValueError, match="capacity"):
        TimelineStore(capacity=0)


# ---------------------------------------------------------------------------
# watchdog sinks
# ---------------------------------------------------------------------------
class _Owner:
    def __init__(self):
        self.fn = lambda x: x * 2


def test_watchdog_feeds_registry_tracer_and_monitor():
    reg, tr, mon = MetricsRegistry(), Tracer(), _FakeMonitor()
    owner = _Owner()
    wd = RecompileWatchdog(registry=reg, tracer=tr, monitor=mon,
                           step_fn=lambda: 42)
    assert wd.attach(owner, "fn", name="fn") is not None
    assert wd.attach(owner, "missing") is None
    owner.fn(torch.ones(4))               # first signature: warmup
    assert wd.warmup_recompiles == 1 and wd.recompiles == 0
    wd.end_warmup()
    owner.fn(torch.ones(4))               # seen: nothing
    assert wd.recompiles == 0
    owner.fn(torch.ones(8))               # a new signature
    assert wd.recompiles == 1
    assert reg.counter("telemetry/recompiles").value == 1
    assert reg.counter("telemetry/recompiles_warmup").value == 1
    ev = wd.events[-1]
    assert ev["program"] == "fn" and not ev["warmup"]
    assert "float32[8]" in ev["signature"]
    assert mon.events == [("telemetry/recompile", 1.0, 42)]
    marks = [e for e in tr.events() if e["name"] == "telemetry/recompile"]
    assert [m["args"]["warmup"] for m in marks] == [True, False]
    assert wd.summary()["programs"] == ["fn"]


def test_watchdog_shared_strict_and_suppressed():
    owner = _Owner()
    wd1, wd2 = RecompileWatchdog(), RecompileWatchdog(strict=True)
    assert wd1.attach(owner, "fn") is wd2.attach(owner, "fn")
    owner.fn(torch.ones(4))
    wd2.check()                           # warmup compiles never raise
    wd1.end_warmup()
    wd2.end_warmup()
    owner.fn(torch.ones(16))
    assert wd1.recompiles == wd2.recompiles == 1
    with pytest.raises(RecompileAfterWarmupError, match="fn"):
        wd2.check()
    wd2.check()                           # reported once
    with pt.suppress_compile_events():
        owner.fn(torch.ones(32))          # out of band: not recorded
    assert wd2.recompiles == 1
    owner.fn(torch.ones(32))              # ...and still unseen
    with pytest.raises(RecompileAfterWarmupError):
        wd2.check()


@pytest.mark.parametrize("args,kwargs", [
    ((np.zeros((2, 3), np.float32), 5), {"flag": True}),
    (([np.zeros((4,), np.int32), np.zeros(2)], None, "s"), {}),
    ((), {"d": {"a": np.zeros((1, 2), np.float32)}, "x": 1.5}),
])
def test_signatures_match_jax(args, kwargs):
    from deepspeed_tpu.telemetry.watchdog import (
        fast_signature as jax_fast_signature)
    assert pt.abstract_signature(args, kwargs) == \
        jt.abstract_signature(args, kwargs)
    assert pt.fast_signature(args, kwargs) == \
        jax_fast_signature(args, kwargs)


# ---------------------------------------------------------------------------
# SLO digests, windows, goodput and burn alerts
# ---------------------------------------------------------------------------
_DISTS = {
    "lognormal": lambda g: g.lognormal(mean=3.0, sigma=1.5, size=5_000),
    "pareto": lambda g: (1.0 + g.pareto(a=1.5, size=5_000)) * 10.0,
    "bimodal": lambda g: np.concatenate([g.normal(5.0, 0.5, size=2_250),
                                         g.normal(5_000.0, 250.0,
                                                  size=2_750)]),
    "uniform_wide": lambda g: g.uniform(0.05, 9e6, size=5_000),
}


@pytest.mark.parametrize("name", sorted(_DISTS))
def test_digest_matches_jax_and_numpy(name):
    vals = np.clip(_DISTS[name](np.random.default_rng(7)), 1e-2, 1e7)
    d, jd = QuantileDigest(), jslo.QuantileDigest()
    for v in vals:
        d.add(float(v))
        jd.add(float(v))
    assert d.counts == jd.counts
    for q in (0.5, 0.9, 0.99):
        assert d.quantile(q) == jd.quantile(q)
        true = float(np.quantile(vals, q))
        assert abs(d.quantile(q) / true - 1.0) < 0.03


def test_digest_edges_merge_and_windows():
    d = QuantileDigest()
    for _ in range(100):
        d.add(42.0)
    assert d.quantile(0.5) == 42.0
    d.add(float("nan"))
    d.add(-3.0)
    assert d.count == 101 and QuantileDigest().quantile(0.5) == 0.0
    a, b = QuantileDigest(), QuantileDigest()
    for v in range(1, 50):
        a.add(float(v))
        b.add(float(v) * 10)
    n = a.count
    a.merge(b)
    assert a.count == n + b.count
    with pytest.raises(ValueError, match="merge"):
        a.merge(QuantileDigest(rel_error=0.02))
    with pytest.raises(ValueError):
        QuantileDigest(min_value=5.0, max_value=1.0)
    wq = WindowedQuantiles(windows=4)
    for _ in range(100):
        wq.add(1000.0)
    for _ in range(3):
        wq.rotate()
        for _ in range(100):
            wq.add(1.0)
    assert wq.quantile(0.99) == pytest.approx(1000.0, rel=0.03)
    wq.rotate()
    for _ in range(100):
        wq.add(1.0)
    assert wq.quantile(0.99) == pytest.approx(1.0, rel=0.03)
    assert wq.count == 400


def test_slo_config_resolve_forms():
    assert SLOConfig.resolve(None) is None and SLOConfig.resolve(False) \
        is None
    assert SLOConfig.resolve(True).classes["default"].ttft_ms == 500.0
    cfg = SLOConfig.resolve({"ttft_ms": 50.0, "window_steps": 16,
                             "classes": {"batch": {"ttft_ms": None,
                                                   "gap_ms": 1000.0}}})
    assert cfg.classes["default"].ttft_ms == 50.0
    assert cfg.classes["default"].gap_ms == 200.0
    assert cfg.classes["batch"].ttft_ms is None and cfg.window_steps == 16
    assert SLOConfig.resolve(cfg) is cfg
    with pytest.raises(TypeError):
        SLOConfig.resolve(123)


def _slo_snap(tracker):
    snap = tracker.snapshot()
    snap.pop("overhead_s")
    return snap


@pytest.mark.parametrize("case", ["goodput", "burn", "per_class", "cancel"])
def test_slo_tracker_matches_jax(case):
    """The same stream through both trackers (with a registry, a tracer
    and a monitor): identical snapshots, alerts, gauges and events."""
    cfgs = {"goodput": {"ttft_ms": 100.0, "gap_ms": None},
            "burn": {"ttft_ms": 100.0, "gap_ms": None, "window_steps": 4,
                     "windows": 4, "goodput_target": 0.9, "warn_burn": 2.0,
                     "page_burn": 5.0},
            "per_class": {"ttft_ms": 100.0, "gap_ms": None,
                          "window_steps": 4, "windows": 4,
                          "classes": {"batch": {"ttft_ms": None,
                                                "gap_ms": None}}},
            "cancel": {"ttft_ms": 100.0, "gap_ms": None}}
    rng = np.random.default_rng(3)
    plan = [(str(rng.choice(["default", "batch", "interactive"])),
             float(rng.choice([0.01, 5.0])), bool(rng.random() < 0.9),
             bool(rng.random() < 0.1)) for _ in range(40)]
    out = []
    for tel, Tracker in ((jt, jslo.SLOTracker), (pt, SLOTracker)):
        reg, tr, mon = tel.MetricsRegistry(), tel.Tracer(), _FakeMonitor()
        t = Tracker(cfgs[case], registry=reg, tracer=tr, monitor=mon)
        for step, (cls, ttft, ok, cancel) in enumerate(plan):
            t.observe_admitted(cls=cls)
            if case == "cancel" and cancel:
                t.observe_cancel(cls=cls)
            elif case != "burn" or step % 3:
                t.observe_finish(ttft_s=ttft, per_token_s=0.001,
                                 e2e_s=ttft + 0.1, ok=ok, cls=cls)
            t.observe_gap(0.002 * (step % 5 + 1))
            t.on_step(step)
        out.append((_slo_snap(t), t.class_alerts, t.class_burns,
                    reg.snapshot(), mon.events,
                    [e["name"] for e in tr.events()]))
    assert out[0] == out[1]
    t.reset()
    assert t.alert_state == "ok" and t.goodput() == 1.0
    assert t.overhead_ns == 0 and t.class_alerts == {}


def test_slo_goodput_and_independent_class_burns():
    t = SLOTracker({"ttft_ms": 100.0, "gap_ms": None})
    for _ in range(8):
        t.observe_admitted()
    for _ in range(6):
        t.observe_finish(ttft_s=0.010)
    t.observe_finish(ttft_s=5.0)
    t.observe_finish(ttft_s=0.010, ok=False)
    assert t.goodput() == pytest.approx(6 / 8)
    t = SLOTracker({"ttft_ms": 100.0, "gap_ms": None, "window_steps": 4,
                    "windows": 4, "goodput_target": 0.9, "warn_burn": 2.0,
                    "page_burn": 5.0,
                    "classes": {"bulk": SLOTargets(ttft_ms=None,
                                                   gap_ms=None)}})
    for step in range(16):
        t.observe_admitted(cls="interactive")
        t.observe_finish(ttft_s=9.0, cls="interactive")
        t.observe_admitted(cls="batch")
        t.observe_finish(ttft_s=0.010, cls="batch")
        t.on_step(step)
    assert t.class_alert("interactive") == "page"
    assert t.class_alert("batch") == "ok" and t.class_alert("x") == "ok"
    assert t.alert_state in ("warn", "page") and t.rotations == 4
    t2 = SLOTracker(True)
    t2.observe_cancel(cls="ghost")
    assert t2.goodput() == 1.0 and t2.admitted_total == 0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def test_recorder_ring_and_post_mortem_match_jax(tmp_path):
    out = []
    for mod, side in ((jfr, "jax"), (pt.flight_recorder, "port")):
        r = mod.FlightRecorder(capacity=4, dump_dir=str(tmp_path / side))
        for i in range(6):
            r.record({"step_id": i, "live": i % 2})
        assert [s["step_id"] for s in r.last(3)] == [3, 4, 5]
        path = r.dump("invariant_violation",
                      error=RuntimeError("free set corrupt"),
                      extra={"violations": ["x"]})
        with open(path) as f:
            pm = json.load(f)
        pm.pop("time_unix")
        out.append((path.split("/")[-1], pm, r.dump_count, r.records_total))
    assert out[0] == out[1]
    name, pm, count, total = out[1]
    assert name == "postmortem-000-step5-invariant_violation.json"
    assert sorted(pm) == sorted(k for k in POST_MORTEM_KEYS
                                if k != "time_unix")
    assert pm["schema_version"] == SCHEMA_VERSION
    assert [s["step_id"] for s in pm["steps"]] == [2, 3, 4, 5]
    assert count == 1 and total == 6
    assert POST_MORTEM_KEYS == jt.POST_MORTEM_KEYS


def test_dump_without_dir_returns_none_and_never_raises(tmp_path):
    r = FlightRecorder(capacity=2)
    r.record({"step_id": 0})
    assert r.dump("stalled") is None and r.dump_count == 0
    blocked = tmp_path / "file-not-dir"
    blocked.write_text("x")
    r.dump_dir = str(blocked)
    assert r.dump("stalled") is None and r.dump_failures == 1
    with pytest.raises(ValueError, match="capacity"):
        FlightRecorder(capacity=0)


# ---------------------------------------------------------------------------
# the serving engine's telemetry
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine():
    torch.manual_seed(0)
    model = P.TransformerLM(P.transformer_config(
        "gpt2", vocab_size=64, max_seq_len=64, n_embd=32, n_layer=2,
        n_head=4, dtype=torch.float32))
    return dst.init_inference(model, config={"dtype": "float32"},
                              device="cpu")


def _server(engine, pool, **kw):
    return ServingEngine(engine, **{"num_slots": 2, "max_queue_depth": 8,
                                    "prefill_chunk": CHUNK,
                                    "paged_kv": POOLS[pool], **kw})


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 64, size=n) \
        .astype(np.int32)


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_timelines_for_every_outcome(engine, pool):
    srv = _server(engine, pool, max_queue_depth=2)
    done = srv.submit(_prompt(53, 6), max_new_tokens=3)
    srv.submit(_prompt(54, 5), max_new_tokens=2)
    full = srv.submit(_prompt(55, 5), max_new_tokens=2)
    srv.run_until_drained(max_steps=50)
    assert done.state is RequestState.FINISHED
    assert srv.timelines.events_of(done.request_id) == \
        ["submitted", "admitted", "first_token", "finished"]
    last = srv.timeline(done.request_id)[-1]["attrs"]
    assert last["reason"] == "length" and last["new_tokens"] == 3
    assert last["chunks"] == 0
    assert srv.timeline(999_999) is None
    assert srv.timelines.events_of(full.request_id) == ["submitted",
                                                        "rejected"]
    assert srv.timeline(full.request_id)[-1]["attrs"]["reason"] == \
        "queue_full"
    # the engine-side length cap, the scheduler's check off
    srv = _server(engine, pool, num_slots=1)
    srv.scheduler.capacity = srv.scheduler.num_pages = None
    req = srv.submit(_prompt(61, 60), max_new_tokens=10)
    srv.run_until_drained(max_steps=100)
    assert req.finish_reason == "length_cap"
    names = srv.timelines.events_of(req.request_id)
    assert names[0] == "submitted" and names[-1] == "finished"
    assert "prefill_chunk" in names
    assert srv.timeline(req.request_id)[-1]["attrs"]["chunks"] == \
        req.chunks > 0
    assert srv.timelines.open_ids() == []


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_timelines_failed_and_requeued(engine, pool):
    srv = _server(engine, pool)
    r1 = srv.submit(_prompt(67, 6), max_new_tokens=6)
    srv.step()
    owner, attr = ((srv.pool, "run_decode") if pool == "paged"
                   else (srv.engine, "decode"))
    orig = getattr(owner, attr)

    def broken(*a, **k):
        raise RuntimeError("injected decode failure")

    setattr(owner, attr, broken)
    try:
        with pytest.raises(RuntimeError, match="injected"):
            srv.step()
    finally:
        setattr(owner, attr, orig)
    last = srv.timeline(r1.request_id)[-1]
    assert last["event"] == "failed" and last["attrs"]["reason"] == "error"

    req = srv.submit(_prompt(101, 6), max_new_tokens=3)
    orig = srv.engine.prefill_at
    srv.engine.prefill_at = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected prefill failure"))
    try:
        with pytest.raises(RuntimeError, match="injected"):
            srv.step()
    finally:
        srv.engine.prefill_at = orig
    last = srv.timeline(req.request_id)[-1]
    assert last["event"] == "requeued"
    assert last["attrs"]["reason"] == "admit_error"
    srv.run_until_drained(max_steps=50)
    assert srv.timelines.events_of(req.request_id)[-1] == "finished"
    srv.check_invariants()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_traced_run_exports_step_spans_and_request_lanes(engine, pool,
                                                         tmp_path):
    srv = _server(engine, pool, tracer=Tracer())
    for seed, n, b in ((71, 5, 3), (72, 9, 4), (73, 6, 2), (74, 40, 2)):
        srv.submit(_prompt(seed, n), max_new_tokens=b)
    srv.run_until_drained(max_steps=50)
    path = tmp_path / "serving.json"
    srv.tracer.export(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    spans = {e["name"] for e in evs if e["ph"] == "X"}
    assert {"serving/step", "serving/grant", "serving/decode",
            "serving/sample", "serving/prefill_batch",
            "serving/prefill_chunk"} <= spans
    reqs = [e for e in evs if e.get("cat") == "request"]
    begins = {e["id"] for e in reqs if e["ph"] == "b"}
    assert len(begins) == 4 and begins == {e["id"] for e in reqs
                                           if e["ph"] == "e"}
    assert {e["ph"] for e in evs if e.get("cat") == "flow"} == {"s", "f"}
    assert any(e["ph"] == "C" and e["name"] == "serving/occupancy"
               for e in evs)
    steps = [e["args"]["step"] for e in evs
             if e["ph"] == "X" and e["name"] == "serving/step"]
    assert steps == sorted(steps) and steps[0] >= 1
    if pool == "paged":
        assert any(e["ph"] == "C" and e["name"] == "paging/pages"
                   for e in evs)


def test_set_tracer_and_disabled_by_default(engine):
    srv = _server(engine, "contiguous", num_slots=1)
    srv.submit(_prompt(75, 5), max_new_tokens=2)
    srv.run_until_drained(max_steps=20)
    assert srv.tracer.events_total == 0 and not srv.tracer.enabled
    tr = Tracer()
    srv.set_tracer(tr)
    assert srv.timelines.tracer is tr and srv.watchdog.tracer is tr
    srv.submit(_prompt(76, 5), max_new_tokens=2)
    srv.run_until_drained(max_steps=20)
    assert any(e["name"] == "serving/step" for e in tr.events())


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_monitor_axis_publish_and_prometheus_health(engine, pool):
    class _Sink(_FakeMonitor):
        write_errors = 3                  # a bare JSONL-style sink

    mon = _Sink()
    srv = _server(engine, pool, monitor=mon, tracer=True)
    for seed in (79, 80, 81):
        srv.submit(_prompt(seed, 6), max_new_tokens=4)
    srv.run_until_drained(max_steps=50)
    for tag, _, step in mon.events:
        assert isinstance(step, int) and 0 <= step <= srv.step_id, tag
    assert len([t for t, _, _ in mon.events
                if t == "serving/new_tokens"]) == 3
    before = len(mon.events)
    n = srv.publish_telemetry()
    assert n > 0 and len(mon.events) == before + n
    assert all(t.startswith("telemetry/") and s == srv.step_id
               for t, _, s in mon.events[before:])
    assert "telemetry/serving/finished" in [t for t, _, _ in
                                            mon.events[before:]]
    assert srv.registry.counter("serving/finished").value == 3
    text = srv.registry.to_prometheus()
    for name in ("telemetry_tracer_events_total", "telemetry_tracer_dropped",
                 "telemetry_flight_recorder_records",
                 "telemetry_postmortem_dumps", "monitor_jsonl_write_errors 3",
                 "timer_serving_step_fetch_ms_count"):
        assert name in text
    snap = srv.registry.snapshot()
    assert snap["telemetry/tracer_events_total"] > 0
    assert snap["telemetry/flight_recorder_records"] == srv.step_id
    if pool == "paged":
        assert "paging_free_pages" in text


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_debug_dump_and_post_mortem_on_planted_violation(engine, pool,
                                                         tmp_path):
    srv = _server(engine, pool, slo=True)
    for seed in (83, 84, 85):
        srv.submit(_prompt(seed, 8), max_new_tokens=8)
    for _ in range(2):
        srv.step()
    d = srv.debug_dump()
    assert d["schema_version"] == SCHEMA_VERSION
    assert d["step_id"] == 2 and d["live"] >= 1 and len(d["steps"]) == 2
    assert d["watchdog"]["recompiles"] == 0
    assert d["telemetry_overhead_s"] >= 0.0
    assert d["slo"]["admitted"] == 3
    assert {r["request_id"] for r in d["requests"]} == {0, 1, 2}
    srv.run_until_drained(max_steps=100)
    assert srv.recorder.dump_count == 0

    srv = _server(engine, pool, dump_dir=str(tmp_path),
                  fault_injector=FaultInjector(seed=0))
    srv.faults.load_schedule({"state_corruption": [1]})
    for seed in (86, 87):
        srv.submit(_prompt(seed, 6), max_new_tokens=4)
    srv.step()
    with pytest.raises(InvariantViolation):
        srv.check_invariants()
    (path,) = sorted(tmp_path.glob("postmortem-*.json"))
    pm = json.loads(path.read_text())
    assert sorted(pm) == sorted(POST_MORTEM_KEYS)
    assert pm["reason"] == "invariant_violation" and "free" in pm["error"]
    last = pm["steps"][-1]
    assert last["step_id"] == srv.step_id and last["live"] == 2
    for key in ("t_unix", "wall_ms", "pending", "prefilling", "free_slots",
                "granted", "finished", "tokens_total", "load_state",
                "alert_state"):
        assert key in last
    assert srv.recorder.dump_count == 1


def test_slo_counts_deadline_expiry_against_goodput(engine):
    t = [0.0]
    srv = _server(engine, "contiguous", clock=lambda: t[0],
                  slo={"ttft_ms": 60_000.0, "gap_ms": 60_000.0,
                       "window_steps": 8})
    good = [srv.submit(_prompt(89 + i, 6), max_new_tokens=3)
            for i in range(3)]
    srv.run_until_drained(max_steps=100)
    assert srv.slo.goodput() == 1.0
    srv.submit(_prompt(92, 6), max_new_tokens=3, deadline_ms=1.0)
    t[0] += 0.01
    srv.step()
    snap = srv.slo.snapshot()
    assert snap["admitted"] == len(good) + 1 and snap["good"] == len(good)
    assert srv.stats()["deadline_expired"] == 1


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_guarded_decode_makes_one_fetch_a_step(engine, pool):
    """The numerics guard's flags ride the tokens' fetch: every step with
    a decode (and its admissions) makes exactly one device-to-host copy,
    the poisoned step included."""
    srv = _server(engine, pool, guard_numerics=True,
                  fault_injector=FaultInjector(
                      seed=0, schedule={"nan_logits": [4]}))
    reqs = [srv.submit(_prompt(s, n), max_new_tokens=8)
            for s, n in ((93, 6), (94, 9), (95, 7))]
    while srv.pending or srv.live_count:
        before = srv.fetches
        srv.step()
        assert srv.fetches - before == 1
    assert sum(r.state is RequestState.FAILED for r in reqs) == 1
    assert srv.metrics.failed_reasons == {"numerical_error": 1}
    assert srv.registry.snapshot()["timer/serving/step_fetch_ms/count"] == \
        srv.fetches


def test_tracer_overhead_is_bounded(engine):
    """Tracing a drained server must not blow up its step cost: the JAX
    test's loose 2x bound."""
    def run(tracer):
        srv = _server(engine, "contiguous", max_queue_depth=64,
                      tracer=tracer)
        for s in range(8):
            srv.submit(_prompt(97 + s, 6), max_new_tokens=8)
        t0 = time.perf_counter()
        srv.run_until_drained(max_steps=200)
        return time.perf_counter() - t0

    run(None)
    base = min(run(None), run(None))
    traced = min(run(Tracer()), run(Tracer()))
    assert traced < base * 2 + 0.05


def test_warmup_manifest_records_then_freezes(engine):
    srv = _server(engine, "contiguous")
    srv.submit(_prompt(23, 6), max_new_tokens=3)
    srv.run_until_drained(max_steps=50)
    man = srv.watchdog.signature_manifest()
    assert any(k.startswith("InferenceEngine.") for k in man)
    flat = [s for sigs in man.values() for s in sigs]
    assert flat and all(s.startswith("(") and s.endswith(")") for s in flat)
    assert any("int64[1,16]" in s
               for s in man.get("InferenceEngine.prefill_at", []))
    srv.end_warmup()
    srv.submit(_prompt(24, 6), max_new_tokens=3)
    srv.run_until_drained(max_steps=50)
    assert srv.watchdog.signature_manifest() == man
    assert srv.watchdog.recompiles == 0
