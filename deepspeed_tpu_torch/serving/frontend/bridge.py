"""Thread bridge between the asyncio front end and the synchronous
serving engine (the port's copy of
``deepspeed_tpu/serving/frontend/bridge.py``).

``ServingEngine.step()`` is a blocking host loop that must never run on
the event loop (a single decode dispatch would stall every connection),
and the engine is not thread-safe (one mutable slot table, one pool).
:class:`AsyncEngineBridge` therefore gives the engine a DEDICATED step
thread and funnels EVERY engine interaction — submit, cancel, stats
reads — through a thread-safe op queue serviced between steps. The
asyncio side never touches the engine directly:

* :meth:`submit` enqueues a submit op and returns ``(request,
  TokenStream)``; the stream is an async iterator fed one event per new
  token, fan-out happening after every ``step()`` from the per-request
  ``output_tokens`` delta.
* **Backpressure** — each stream's buffer is a bounded ``asyncio.Queue``.
  The step thread must never block on a slow reader, so an overflowing
  stream is closed with a ``slow_consumer`` error and its engine-side
  request cancelled (freeing the slot/pages for clients that ARE
  reading) rather than stalling the batch.
* :meth:`cancel` is the ``DELETE /v1/requests/{id}`` path: the op runs
  :meth:`ServingEngine.cancel` between steps, so a mid-PREFILLING or
  mid-decode cancellation lands on a step boundary where the rollback
  (slot release, page refcount decrement) is exception-safe by
  construction.
* :meth:`stop` **drains on shutdown**: in-flight requests finish (or
  hit the drain timeout) before the thread exits; still-open streams
  then get a terminal ``shutdown`` event, so no reader hangs.

The step thread parks on the op queue when the engine is idle (no
polling spin) with a short timeout so deadline expiry still fires for
queued work.

CUDA: the step thread is the only thread that touches the engine, and so
the card. A CUDA graph captured while another thread calls into CUDA (an
allocation, a synchronize) fails under PyTorch's default capture mode, so
the event loop's side (handlers, clients) must make no CUDA call: even
``/metrics`` and ``/healthz`` read through :meth:`AsyncEngineBridge.call`.
Warm each server (its captures included) before the bridge starts.
"""

from __future__ import annotations

import asyncio
import queue as _queue
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..request import Request, RequestState

#: lifecycle states with nothing left to stream
_TERMINAL = (RequestState.FINISHED, RequestState.REJECTED,
             RequestState.FAILED)


class TokenStream:
    """Async iterator over one request's streamed events.

    Events are plain dicts: ``{"event": "token", "token": int,
    "index": int}`` per generated token, then exactly one terminal
    event — ``{"event": "done", "reason": ...}`` (includes
    ``"cancelled"``) or ``{"event": "error", "reason": ...}``. The
    terminal event is yielded too (the SSE layer forwards it), after
    which iteration stops."""

    def __init__(self, maxsize: int, loop: asyncio.AbstractEventLoop):
        self.q: asyncio.Queue = asyncio.Queue(maxsize=maxsize)
        self.loop = loop
        self.request_id: Optional[int] = None
        self.req: Optional[Request] = None
        self.sent = 0             # tokens already fanned out (step thread)
        self.closed = False       # producer-side: terminal event emitted
        self._finished = False    # consumer-side: terminal event yielded

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> Dict[str, Any]:
        if self._finished:
            raise StopAsyncIteration
        ev = await self.q.get()
        if ev.get("event") in ("done", "error"):
            self._finished = True
        return ev


class AsyncEngineBridge:
    """Owns the engine's step thread; see module docstring."""

    def __init__(self, srv: Any, stream_buffer: int = 256,
                 idle_poll_s: float = 0.02,
                 drain_timeout_s: float = 30.0):
        if stream_buffer < 2:
            raise ValueError(f"stream_buffer must be >= 2 (token + "
                             f"terminal event), got {stream_buffer}")
        self.srv = srv
        self.stream_buffer = int(stream_buffer)
        self.idle_poll_s = float(idle_poll_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self._ops: "_queue.Queue[Tuple]" = _queue.Queue()
        self._streams: Dict[int, TokenStream] = {}
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stopping = False
        self._draining = False
        self.steps = 0            # step-thread iterations that ran step()
        self._thread_error: Optional[BaseException] = None

    # -- lifecycle (event-loop side) -----------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    async def start(self) -> None:
        if self.running:
            raise RuntimeError("bridge already started")
        self._loop = asyncio.get_running_loop()
        # written before Thread.start(), which publishes them; only
        # _apply_op writes them afterwards
        self._stopping = self._draining = False
        self._thread = threading.Thread(
            target=self._run, name="serving-step", daemon=True)
        self._thread.start()

    async def stop(self, drain: bool = True) -> None:
        """Stop the step thread. With ``drain=True`` (default), seated
        and queued requests run to completion first (bounded by
        ``drain_timeout_s``); streams still open after the thread exits
        get a terminal ``shutdown`` event either way."""
        if self._thread is None:
            return
        self._ops.put(("stop", drain, None, None))
        await asyncio.get_running_loop().run_in_executor(
            None, self._thread.join)
        self._thread = None
        # ops that raced the shutdown decision (enqueued after the step
        # thread's final queue drain) must fail fast, not hang their
        # awaiting coroutines; nothing services the queue anymore and
        # _require_running rejects new ops from here on
        self._reject_pending_ops("stopped")
        # safety net: terminal events for anything the thread left open
        for st in list(self._streams.values()):
            self._emit(st, [{"event": "done", "reason": "shutdown",
                             "request_id": st.request_id}])
        # the step thread was joined above: single-threaded cleanup
        self._streams.clear()
        if self._thread_error is not None:
            raise self._thread_error

    # -- async API (event-loop side) -----------------------------------
    async def submit(self, prompt, **submit_kw
                     ) -> Tuple[Request, TokenStream]:
        """Submit a generation request from the event loop. Returns the
        engine's :class:`Request` (check ``state`` — a REJECTED request
        carries ``reject_reason``/``retry_after_s`` and its stream just
        yields one terminal ``rejected`` event) and its token stream."""
        self._require_running()
        stream = TokenStream(self.stream_buffer, self._loop)
        fut: asyncio.Future = self._loop.create_future()
        self._ops.put(("submit", (prompt, submit_kw), stream, fut))
        req = await fut
        return req, stream

    async def cancel(self, request_id: int) -> bool:
        """Cancel by id (client disconnect / DELETE). Returns whether
        the engine still knew the request."""
        self._require_running()
        fut: asyncio.Future = self._loop.create_future()
        self._ops.put(("cancel", int(request_id), None, fut))
        return await fut

    async def call(self, fn):
        """Run ``fn(srv)`` on the step thread between steps and return
        its result — the only sanctioned way for the front end to READ
        engine state (stats, load state, Prometheus exposition); the
        engine's dicts are mutated mid-step, so even reads must be
        serialized onto the step thread."""
        self._require_running()
        fut: asyncio.Future = self._loop.create_future()
        self._ops.put(("call", fn, None, fut))
        return await fut

    def _require_running(self) -> None:
        if not self.running or self._loop is None:
            raise RuntimeError("bridge is not running (call start())")

    # -- step thread ---------------------------------------------------
    def _run(self) -> None:
        try:
            self._loop_body()
        except BaseException as e:  # surfaced by stop()
            self._thread_error = e
            self._fail_open_streams(repr(e))
            self._reject_pending_ops("step thread crashed")

    def _has_work(self) -> bool:
        srv = self.srv
        # duck-typed: a ReplicaRouter exposes has_work() (aggregated over
        # alive replicas); a bare engine is probed through its internals
        probe = getattr(srv, "has_work", None)
        if callable(probe):
            return bool(probe())
        return bool(srv.live_count or srv.scheduler.pending
                    or getattr(srv, "_prefill_queue", None))

    def _loop_body(self) -> None:
        srv = self.srv
        drain_deadline = None
        while True:
            # 1) drain ops; park here when idle (no busy spin, but wake
            #    within idle_poll_s so queued-work deadlines still expire)
            budget = 64
            try:
                block = not self._has_work() and not self._stopping
                op = self._ops.get(block=block,
                                   timeout=self.idle_poll_s if block
                                   else None)
            except _queue.Empty:
                op = None
            while op is not None:
                self._apply_op(op)
                budget -= 1
                if budget <= 0:
                    break  # bounded: submit floods must not starve step()
                try:
                    op = self._ops.get_nowait()
                except _queue.Empty:
                    op = None
            # 2) stop/drain bookkeeping
            if self._stopping:
                if drain_deadline is None:
                    drain_deadline = (srv._now() + self.drain_timeout_s
                                      if self._draining else srv._now())
                if not self._draining or not self._has_work() \
                        or srv._now() >= drain_deadline:
                    self._fail_open_streams("shutdown", kind="done")
                    self._reject_pending_ops("stopping")
                    return
            # 3) one engine step when there is work
            if self._has_work():
                srv.step()
                self.steps += 1
                self._fan_out()

    def _apply_op(self, op: Tuple) -> None:
        kind, payload, stream, fut = op
        srv = self.srv
        if kind == "stop":
            self._stopping = True
            self._draining = bool(payload)
            return
        try:
            if kind == "submit":
                prompt, kw = payload
                req = srv.submit(prompt, **kw)
                stream.req = req
                stream.request_id = req.request_id
                if req.state is RequestState.REJECTED:
                    self._emit(stream, [{
                        "event": "done", "reason": "rejected",
                        "request_id": req.request_id,
                        "reject_reason":
                            getattr(req.reject_reason, "value",
                                    req.reject_reason),
                        "retry_after_s": req.retry_after_s}])
                else:
                    self._streams[req.request_id] = stream
                self._resolve(fut, req)
            elif kind == "cancel":
                req = srv.cancel(payload)
                st = self._streams.pop(payload, None)
                if st is not None and req is not None:
                    self._emit(st, [self._terminal_event(req)])
                self._resolve(fut, req is not None)
            elif kind == "call":
                self._resolve(fut, payload(srv))
        except BaseException as e:
            self._reject(fut, e)

    def _fan_out(self) -> None:
        """After one step: push each tracked request's new tokens, and a
        terminal event when it retired. Preempted requests stay tracked
        — their ``output_tokens`` (and our ``sent`` cursor) survive the
        bounce by design."""
        for rid, st in list(self._streams.items()):
            req = st.req
            new = req.output_tokens[st.sent:]
            if new:
                base = st.sent
                self._emit(st, [
                    {"event": "token", "token": int(t),
                     "index": base + i, "request_id": rid}
                    for i, t in enumerate(new)])
                st.sent += len(new)
            if req.state in _TERMINAL:
                self._emit(st, [self._terminal_event(req)])
                del self._streams[rid]

    @staticmethod
    def _terminal_event(req: Request) -> Dict[str, Any]:
        reason = getattr(req.finish_reason, "value", req.finish_reason)
        if req.state is RequestState.FAILED:
            return {"event": "error", "reason": reason or "error",
                    "request_id": req.request_id,
                    "tokens": len(req.output_tokens)}
        return {"event": "done", "reason": reason or "unknown",
                "request_id": req.request_id,
                "tokens": len(req.output_tokens)}

    def _fail_open_streams(self, reason: str, kind: str = "error") -> None:
        for rid, st in list(self._streams.items()):
            self._emit(st, [{"event": kind, "reason": reason,
                             "request_id": rid}])
        self._streams.clear()

    def _reject_pending_ops(self, why: str) -> None:
        """Reject the futures of ops still queued once the step thread
        can no longer service them (post-drain stop, thread crash). A
        lost op must fail fast — before this existed, a ``call()`` or
        ``submit()`` racing ``stop()`` could enqueue after the thread's
        final queue drain and await its future forever. Runs on either
        side of the boundary (the queue is thread-safe and ``_reject``
        marshals through the loop)."""
        while True:
            try:
                kind, _payload, _stream, fut = self._ops.get_nowait()
            except _queue.Empty:
                return
            self._reject(fut, RuntimeError(
                f"bridge {why}: {kind} op was not serviced"))

    # -- cross-thread plumbing -----------------------------------------
    def _resolve(self, fut: Optional[asyncio.Future], value) -> None:
        if fut is not None:
            self._loop.call_soon_threadsafe(self._set_result, fut, value)

    def _reject(self, fut: Optional[asyncio.Future],
                err: BaseException) -> None:
        if fut is not None:
            self._loop.call_soon_threadsafe(self._set_exception, fut, err)

    @staticmethod
    def _set_result(fut: asyncio.Future, value) -> None:
        if not fut.done():
            fut.set_result(value)

    @staticmethod
    def _set_exception(fut: asyncio.Future, err: BaseException) -> None:
        if not fut.done():
            fut.set_exception(err)

    def _emit(self, st: TokenStream, events: List[Dict[str, Any]]) -> None:
        """Push events onto a stream's queue from ANY thread (the loop
        thread delivers). Never blocks the caller."""
        if st.closed:
            return
        for ev in events:
            if ev.get("event") in ("done", "error"):
                st.closed = True
        self._loop.call_soon_threadsafe(self._deliver, st, events)

    def _deliver(self, st: TokenStream, events: List[Dict[str, Any]]
                 ) -> None:
        """Runs on the event loop: enqueue without blocking; a full
        buffer means the consumer stopped reading — close the stream
        with ``slow_consumer`` and cancel the engine-side request
        (backpressure policy: protect the batch, drop the deaf reader).
        """
        for ev in events:
            try:
                st.q.put_nowait(ev)
            except asyncio.QueueFull:
                st.closed = True
                while not st.q.empty():
                    st.q.get_nowait()
                st.q.put_nowait({"event": "error",
                                 "reason": "slow_consumer",
                                 "request_id": st.request_id})
                if st.request_id is not None:
                    # free the engine-side slot/pages; drop the tracking
                    # entry via the normal cancel op
                    self._ops.put(("cancel", st.request_id, None, None))
                return
