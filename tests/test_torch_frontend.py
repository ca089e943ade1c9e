"""The port's async front end on the CPU: the step-thread bridge
(``AsyncEngineBridge``, ``TokenStream``) and the stdlib HTTP/SSE server
(``ServingFrontend``) over a bare server and over a disaggregated fleet
(the cases of the JAX ``tests/unit/serving/test_frontend.py::TestBridge``
and ``test_frontend_e2e.py``).

Timing rules, so a loaded host cannot make a case flaky or hang the
suite: events are ordered with futures, ``bridge.call`` round trips and
stream reads, never with sleeps; every coroutine runs under
``asyncio.wait_for`` with a hard limit; every server binds port 0 on
127.0.0.1.
"""

import asyncio
import json

import numpy as np
import pytest

from deepspeed_tpu_torch.serving import (AsyncEngineBridge, FinishReason,
                                         ReplicaRouter, RequestState,
                                         ServingEngine, ServingFrontend,
                                         TokenStream)

from _torch_fleet import make_prompts, paged_server, port_engine, warm
from _torch_threads import one_thread  # noqa: F401

LIMIT_S = 60.0
# a cold first step lands in TTFT; keep burn shedding out of these flows
LENIENT_SLO = {"ttft_ms": 6e5, "gap_ms": 6e5}


@pytest.fixture(scope="module")
def engine():
    return port_engine(seed=6, graphs=False)


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _srv(engine, **kw):
    kw.setdefault("num_slots", 2)
    return ServingEngine(engine, **kw)


def _assert_clean(srv):
    srv.check_invariants()
    assert srv.pool.free_count == srv.pool.num_slots
    assert srv.live_count == 0
    assert srv.timelines.open_ids() == []


async def _collect(stream):
    return [ev async for ev in stream]


async def _until(bridge, pred, tries: int = 10_000):
    """Round-trip ``bridge.call(pred)`` until it holds (each call waits
    for the step thread's next op drain: no sleep)."""
    for _ in range(tries):
        if await bridge.call(pred):
            return
    raise AssertionError("condition never held")


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------
def test_submit_streams_tokens_then_done(engine):
    srv = _srv(engine)

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        try:
            req, stream = await bridge.submit([1, 2, 3, 4], max_new_tokens=5)
            assert isinstance(stream, TokenStream)
            events = await _collect(stream)
        finally:
            await bridge.stop()
        return req, events

    req, events = _run(run())
    tokens = [e for e in events if e["event"] == "token"]
    assert [e["index"] for e in tokens] == list(range(len(tokens)))
    assert [e["token"] for e in tokens] == req.output_tokens
    assert events[-1] == {"event": "done", "reason": "length",
                          "request_id": req.request_id, "tokens": 5}
    want = engine.generate(np.asarray([[1, 2, 3, 4]]), max_new_tokens=5)
    assert req.output_tokens == want[0, 4:].tolist()
    _assert_clean(srv)


def test_concurrent_streams_all_complete(engine):
    srv = _srv(engine)

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        try:
            pairs = [await bridge.submit([1 + i, 2, 3], max_new_tokens=4 + i)
                     for i in range(5)]
            results = await asyncio.gather(*[_collect(s) for _, s in pairs])
        finally:
            await bridge.stop()
        return pairs, results

    pairs, results = _run(run())
    for (req, _), events in zip(pairs, results):
        assert events[-1]["event"] == "done"
        assert events[-1]["request_id"] == req.request_id
        assert len(events) == 1 + req.max_new_tokens
    _assert_clean(srv)


def test_cancel_mid_stream_emits_terminal_cancelled(engine):
    srv = _srv(engine)

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        try:
            req, stream = await bridge.submit([1, 2, 3], max_new_tokens=48)
            first = await stream.__anext__()
            assert await bridge.cancel(req.request_id) is True
            rest = await _collect(stream)
            assert await bridge.cancel(req.request_id) is False
            assert await bridge.cancel(31337) is False
        finally:
            await bridge.stop()
        return first, rest

    first, rest = _run(run())
    assert first["event"] == "token"
    assert rest[-1]["event"] == "done" and rest[-1]["reason"] == "cancelled"
    assert sum(e["event"] in ("done", "error") for e in rest) == 1
    _assert_clean(srv)


def test_rejected_submit_yields_single_terminal_event(engine):
    """One slot and a queue of one: the third submit is refused. The first
    request's budget keeps the slot busy far longer than the two submits
    that follow it take (each waits at most one step)."""
    srv = _srv(engine, num_slots=1, max_queue_depth=1)

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        try:
            _, s1 = await bridge.submit([1, 2], max_new_tokens=48)
            await s1.__anext__()                 # seated and decoding
            await bridge.submit([1, 2], max_new_tokens=4)
            req, stream = await bridge.submit([1, 2], max_new_tokens=4)
            events = await _collect(stream)
        finally:
            await bridge.stop()
        return req, events

    req, events = _run(run())
    assert req.state is RequestState.REJECTED
    assert len(events) == 1
    assert events[0]["reason"] == "rejected"
    assert events[0]["reject_reason"] == "queue_full"
    _assert_clean(srv)


def test_slow_consumer_is_closed_and_cancelled(engine):
    srv = _srv(engine)

    async def run():
        bridge = AsyncEngineBridge(srv, stream_buffer=2, idle_poll_s=0.005)
        await bridge.start()
        try:
            req, stream = await bridge.submit([1, 2, 3], max_new_tokens=48)
            # a deaf consumer: never reads until the bridge gave up on it
            await _until(bridge,
                         lambda s: req.state is RequestState.FINISHED)
            ev = await stream.__anext__()
            with pytest.raises(StopAsyncIteration):
                await stream.__anext__()
        finally:
            await bridge.stop()
        return req, ev

    req, ev = _run(run())
    assert ev == {"event": "error", "reason": "slow_consumer",
                  "request_id": req.request_id}
    assert req.finish_reason is FinishReason.CANCELLED
    _assert_clean(srv)


def test_call_serializes_reads_onto_step_thread(engine):
    srv = _srv(engine)

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        try:
            _, stream = await bridge.submit([1, 2], max_new_tokens=4)
            stats = await bridge.call(lambda s: s.stats())
            await _collect(stream)
        finally:
            await bridge.stop()
        return stats

    stats = _run(run())
    assert isinstance(stats, dict) and "completed" in stats


def test_stop_drains_or_closes(engine):
    srv = _srv(engine)

    async def drained():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        req, stream = await bridge.submit([1, 2, 3], max_new_tokens=8)
        await bridge.stop(drain=True)       # no reads before stop
        return req, await _collect(stream)

    req, events = _run(drained())
    assert req.finish_reason is FinishReason.LENGTH
    assert events[-1]["event"] == "done" and len(events) == 9
    _assert_clean(srv)

    async def closed():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.005)
        await bridge.start()
        req, stream = await bridge.submit([1, 2, 3], max_new_tokens=48)
        await stream.__anext__()
        await bridge.stop(drain=False)
        assert not bridge.running
        return await _collect(stream)

    events = _run(closed())
    assert events[-1] == {"event": "done", "reason": "shutdown",
                          "request_id": events[-1]["request_id"]}
    srv.check_invariants()


def test_validation_and_leftover_ops(engine):
    srv = _srv(engine)
    with pytest.raises(ValueError, match="stream_buffer"):
        AsyncEngineBridge(srv, stream_buffer=1)

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.002)
        with pytest.raises(RuntimeError, match="not running"):
            await bridge.call(lambda s: 0)
        await bridge.start()
        with pytest.raises(RuntimeError, match="already started"):
            await bridge.start()
        with pytest.raises(ValueError, match="max_new_tokens"):
            await bridge.submit([1, 2], max_new_tokens=0)
        await bridge.stop(drain=False)
        # an op that slipped past the step thread's last drain is rejected
        fut = asyncio.get_running_loop().create_future()
        bridge._ops.put(("call", (lambda s: 0), None, fut))
        bridge._reject_pending_ops("stopped")
        with pytest.raises(RuntimeError, match="not serviced"):
            await fut
        assert bridge._ops.empty()

    _run(run())
    _assert_clean(srv)


def test_concurrent_calls_racing_stop_never_hang(engine):
    """call() coroutines hammer the op queue while stop(drain=True) runs:
    each returns a value or raises RuntimeError, none hangs."""
    srv = _srv(engine)

    async def one_round(bridge):
        await bridge.start()
        outcomes = {"ok": 0, "rejected": 0}

        async def hammer():
            while True:
                try:
                    assert await bridge.call(lambda s: s.live_count) == 0
                except RuntimeError:
                    outcomes["rejected"] += 1
                    return
                outcomes["ok"] += 1

        tasks = [asyncio.ensure_future(hammer()) for _ in range(6)]
        await bridge.call(lambda s: None)        # the hammers are running
        await bridge.stop(drain=True)
        await asyncio.gather(*tasks)
        assert outcomes["rejected"] == 6
        assert bridge._ops.empty()
        return outcomes["ok"]

    async def run():
        bridge = AsyncEngineBridge(srv, idle_poll_s=0.002)
        return sum([await one_round(bridge) for _ in range(5)])

    assert _run(run()) > 0
    _assert_clean(srv)


# ---------------------------------------------------------------------------
# HTTP/SSE over a real localhost socket
# ---------------------------------------------------------------------------
def _http_bytes(method, path, body=None):
    payload = b"" if body is None else json.dumps(body).encode("utf-8")
    head = (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n")
    return head.encode("latin-1") + payload


async def _request(port, method, path, body=None):
    """One exchange; returns (status, headers, body bytes) (the server
    closes each connection)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(_http_bytes(method, path, body))
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split(" ")[1]), headers, payload


async def _next_frame(reader):
    """One ``event:``/``data:`` SSE frame, or None at EOF."""
    try:
        block = await reader.readuntil(b"\n\n")
    except asyncio.IncompleteReadError:
        return None
    event = data = None
    for line in block.decode("utf-8").strip().split("\n"):
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            data = json.loads(line[len("data: "):])
    return event, data


async def _open_stream(port, payload):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(_http_bytes("POST", "/v1/generate", payload))
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    return int(head.split(b" ")[1]), reader, writer


async def _rest(reader, writer):
    frames = []
    while True:
        fr = await _next_frame(reader)
        if fr is None:
            break
        frames.append(fr)
        if fr[0] in ("done", "error"):
            break
    writer.close()
    await writer.wait_closed()
    return frames


async def _generate(port, payload):
    """POST /v1/generate to completion: (status, frames), or (status, the
    error JSON) when refused before the stream."""
    status, reader, writer = await _open_stream(port, payload)
    if status != 200:
        body = await reader.read()
        writer.close()
        await writer.wait_closed()
        return status, json.loads(body) if body else {}
    return status, await _rest(reader, writer)


def _frontend(engine, **srv_kw):
    srv = _srv(engine, **srv_kw)
    return srv, ServingFrontend(srv, port=0, idle_poll_s=0.005)


def test_concurrent_streams_cancel_and_deadline_over_http(engine):
    """Concurrent SSE streams, one cancelled mid-stream by DELETE and one
    expiring its deadline in the queue behind two busy slots: every
    timeline closes and nothing leaks."""
    srv, fe = _frontend(engine, priority=True, slo=LENIENT_SLO)

    async def run():
        await fe.start()
        port = fe.port
        assert port != 0
        try:
            st, frames = await _generate(port, {"prompt": [1, 2, 3],
                                                "max_new_tokens": 2})
            assert st == 200
            # two long streams take both slots
            st, r1, w1 = await _open_stream(port, {"prompt": [9, 9, 9],
                                                   "max_new_tokens": 48})
            st2, r2, w2 = await _open_stream(port, {"prompt": [8, 8],
                                                    "max_new_tokens": 40})
            assert (st, st2) == (200, 200)
            ev, start = await _next_frame(r1)
            assert ev == "start"
            rid = start["request_id"]
            assert (await _next_frame(r1))[0] == "token"
            head2 = [await _next_frame(r2), await _next_frame(r2)]
            assert head2[1][0] == "token"
            # queued behind both: 30 ms is far shorter than their decodes
            expiring = await _generate(port, {
                "prompt": [5, 5, 5], "max_new_tokens": 4,
                "deadline_ms": 30.0, "priority": "batch"})
            st, _, body = await _request(port, "DELETE",
                                         f"/v1/requests/{rid}")
            assert st == 200 and json.loads(body) == {"cancelled": rid}
            cancelled = await _rest(r1, w1)
            normals = await asyncio.gather(_rest(r2, w2), *[
                _generate(port, {"prompt": [1 + i, 2, 3],
                                 "max_new_tokens": 4 + i,
                                 "priority": "interactive",
                                 "tenant": f"t{i}"}) for i in range(3)])
        finally:
            await fe.stop()
        return rid, cancelled, expiring, [head2 + normals[0]] + [
            frames for _, frames in normals[1:]]

    rid, cancelled, (exp_status, exp_frames), streams = _run(run())
    assert cancelled[-1] == ("done", {"event": "done", "reason": "cancelled",
                                      "request_id": rid,
                                      "tokens": cancelled[-1][1]["tokens"]})
    assert exp_status == 200 and exp_frames[-1][1]["reason"] == "deadline"
    for frames in streams:
        toks = [d for e, d in frames if e == "token"]
        assert [t["index"] for t in toks] == list(range(len(toks)))
        assert frames[-1][0] == "done" and frames[-1][1]["reason"] == "length"
    _assert_clean(srv)
    assert srv.timeline(rid)[-1]["attrs"]["reason"] == "cancelled"


def test_healthz_and_metrics(engine):
    srv, fe = _frontend(engine, priority=True, slo=LENIENT_SLO)

    async def run():
        await fe.start()
        try:
            return (await _request(fe.port, "GET", "/healthz"),
                    await _request(fe.port, "GET", "/metrics"))
        finally:
            await fe.stop()

    (hst, _, hbody), (mst, mhdr, mbody) = _run(run())
    info = json.loads(hbody)
    assert hst == 200 and info["state"] == "healthy"
    assert info["num_slots"] == 2 and info["live_slots"] == 0
    assert set(info["class_queue_depths"]) == {"interactive", "standard",
                                               "batch"}
    assert "class_alerts" in info and "goodput" in info
    assert "fleet" not in info
    assert mst == 200 and mhdr["content-type"].startswith("text/plain")
    assert b"# TYPE" in mbody


def test_rejections_map_to_http_errors_before_the_stream(engine):
    srv, fe = _frontend(
        engine, num_slots=1, max_queue_depth=1,
        priority={"tenants": {"slow": {"tokens_per_s": 1.0,
                                       "burst_tokens": 8.0}}})

    async def run():
        await fe.start()
        try:
            return (await _generate(fe.port, {"prompt": [1, 2, 3],
                                              "max_new_tokens": 8,
                                              "tenant": "slow"}),
                    await _generate(fe.port, {"prompt": [1] * 60,
                                              "max_new_tokens": 32}))
        finally:
            await fe.stop()

    (st1, body1), (st2, body2) = _run(run())
    assert st1 == 429 and body1["reject_reason"] == "rate_limited"
    assert body1["retry_after_s"] > 0
    assert st2 == 400 and body2["reject_reason"] == "prompt_too_long"
    _assert_clean(srv)


def test_client_disconnect_mid_stream_cancels_request(engine):
    srv, fe = _frontend(engine)

    async def run():
        await fe.start()
        try:
            st, reader, writer = await _open_stream(
                fe.port, {"prompt": [1, 2, 3], "max_new_tokens": 48})
            _, data = await _next_frame(reader)
            rid = data["request_id"]
            await _next_frame(reader)                 # a token flowing
            writer.transport.abort()                  # the client vanishes
            await _until(fe.bridge, lambda s: s.live_count == 0
                         and s.scheduler.pending == 0)
        finally:
            await fe.stop()
        return rid

    rid = _run(run())
    _assert_clean(srv)
    events = srv.timeline(rid)
    assert events[-1]["event"] == "finished"
    assert events[-1]["attrs"]["reason"] == "cancelled"


def test_malformed_requests(engine):
    srv, fe = _frontend(engine)

    async def run():
        await fe.start()
        port = fe.port
        try:
            return {
                "no_route": await _request(port, "GET", "/nope"),
                "bad_method": await _request(port, "GET", "/v1/generate"),
                "bad_json": await _request(port, "POST", "/v1/generate"),
                "bad_prompt": await _request(port, "POST", "/v1/generate",
                                             {"prompt": "hi"}),
                "unknown_field": await _request(
                    port, "POST", "/v1/generate",
                    {"prompt": [1], "stream": True}),
                "bad_cancel_id": await _request(port, "DELETE",
                                                "/v1/requests/xyz"),
                "unknown_cancel": await _request(port, "DELETE",
                                                 "/v1/requests/424242"),
                "get_cancel": await _request(port, "GET", "/v1/requests/1"),
            }
        finally:
            await fe.stop()

    r = _run(run())
    assert {k: v[0] for k, v in r.items()} == {
        "no_route": 404, "bad_method": 405, "bad_json": 400,
        "bad_prompt": 400, "unknown_field": 400, "bad_cancel_id": 400,
        "unknown_cancel": 404, "get_cancel": 405}
    assert "stream" in json.loads(r["unknown_field"][2])["error"]
    _assert_clean(srv)


def test_fleet_frontend_streams_generate_tokens_with_zero_recompiles():
    """The front end over a warmed disaggregated fleet on one captured
    engine: SSE tokens equal ``generate()``'s, every one having ridden a
    cross-pool page transfer; ``/healthz`` carries the fleet block,
    ``/metrics`` the labelled exposition; 0 recompiles after warmup."""
    eng = port_engine(seed=8)
    router = ReplicaRouter([paged_server(eng, "prefill",
                                         strict_recompile=True),
                            paged_server(eng, "decode",
                                         strict_recompile=True)])
    warm(router)
    fe = ServingFrontend(router, port=0, idle_poll_s=0.005)
    prompts = make_prompts(41)

    async def run():
        await fe.start()
        try:
            results = await asyncio.gather(*[
                _generate(fe.port, {"prompt": p.tolist(),
                                    "max_new_tokens": 5})
                for p in prompts])
            h = await _request(fe.port, "GET", "/healthz")
            m = await _request(fe.port, "GET", "/metrics")
            recompiles = await fe.bridge.call(lambda r: r.recompiles)
        finally:
            await fe.stop(drain=True)
        return results, h, m, recompiles

    results, (hst, _, hbody), (mst, _, mbody), recompiles = _run(run())
    assert recompiles == 0
    for p, (st, frames) in zip(prompts, results):
        assert st == 200 and frames[0][0] == "start"
        toks = [d["token"] for e, d in frames if e == "token"]
        want = eng.generate(p[None], max_new_tokens=5)[0, len(p):]
        assert toks == want.tolist()
        assert frames[-1][1]["reason"] == "length"
    info = json.loads(hbody)
    assert hst == 200 and info["num_slots"] == 4 and info["live_slots"] == 0
    fleet = info["fleet"]
    assert fleet["counts"] == {"prefill": 1, "decode": 1, "both": 0}
    assert fleet["transfers_in_flight"] == 0
    assert fleet["transfers_total"] >= 2 * len(prompts)
    fh = info["fleet_health"]
    assert fh["replicas"]["0"]["role"] == "prefill"
    assert fh["journeys"]["complete"] == fh["journeys"]["finished"]
    text = mbody.decode("utf-8")
    assert mst == 200 and "router_fleet_size 2" in text
    assert 'replica="1",role="decode"' in text
    router.check_invariants()
    for rep in router.replicas:
        assert rep.live_count == 0 and rep.pool.free_count == 2
