"""Stdlib-only asyncio HTTP/1.1 + SSE serving front end (the port's copy
of ``deepspeed_tpu/serving/frontend/server.py``).

No web framework, no new dependencies: ``asyncio.start_server`` plus a
hand-rolled HTTP/1.1 request parser and ``text/event-stream`` writer.
The surface mirrors the reference project's inference-server entry
points (DeepSpeed-MII's REST/gRPC shell around the inference engine):

* ``POST /v1/generate`` — submit a generation request; the response is
  a Server-Sent-Events stream: one ``start`` event carrying the
  ``request_id`` (the cancellation handle), one ``token`` event per
  generated token, then exactly one terminal ``done``/``error`` event.
  Rejections map to HTTP errors BEFORE the stream starts: 429 with a
  ``Retry-After`` header (queue full / shed / rate-limited / tenant
  quota) or 400 (prompt too long / bad request).
* ``DELETE /v1/requests/{id}`` — cancel a queued or running request;
  the engine frees its slot/pages through the preemption rollback.
* ``GET /healthz`` — load state from the :class:`LoadStateMachine`
  (``healthy``/``pressured``/``overloaded``), queue/slot occupancy and
  per-class queue depths; 503 + ``Retry-After`` when overloaded so
  upstream balancers back off before the engine has to shed. When the
  bridge fronts a :class:`ReplicaRouter` the payload gains a ``fleet``
  object (per-role replica counts, transfers in flight, last scale
  event) and the load state aggregates over prefill-capable replicas.
* ``GET /metrics`` — the Prometheus exposition. A bare engine serves
  its own ``MetricsRegistry.to_prometheus``; a router serves the
  MERGED fleet exposition (``FleetTelemetry.to_prometheus``): router
  series unlabeled, every replica's series labeled
  ``replica="i",role="..."``, plus derived ``fleet_*`` gauges
  (merged-digest p50/p99, fleet goodput/burn, journey completeness,
  transfer-latency quantiles).

Every engine interaction goes through the :class:`AsyncEngineBridge`
(one dedicated step thread; see ``bridge.py``) — handlers never touch
the engine directly. A client disconnect mid-stream surfaces as a write
failure (or cancelled handler task) and triggers ``bridge.cancel``, so
an abandoned stream releases its slot within a step.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional, Tuple

from .bridge import AsyncEngineBridge

_MAX_HEADER_BYTES = 16 * 1024
_MAX_BODY_BYTES = 8 * 1024 * 1024

#: RejectReason.value -> (HTTP status, include Retry-After)
_REJECT_STATUS = {
    "queue_full": (429, True),
    "retry_after": (429, True),
    "rate_limited": (429, True),
    "tenant_quota": (429, True),
    "prompt_too_long": (400, False),
}

_STATUS_TEXT = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 413: "Payload Too Large",
                429: "Too Many Requests", 500: "Internal Server Error",
                503: "Service Unavailable"}


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


async def _read_request(reader: asyncio.StreamReader
                        ) -> Optional[Tuple[str, str, Dict[str, str],
                                            bytes]]:
    """Parse one HTTP/1.1 request; returns (method, path, headers,
    body) or None on a clean EOF before any bytes."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise _BadRequest(400, "truncated request head")
    except asyncio.LimitOverrunError:
        raise _BadRequest(413, "request head too large")
    if len(head) > _MAX_HEADER_BYTES:
        raise _BadRequest(413, "request head too large")
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise _BadRequest(400, f"malformed request line: {lines[0]!r}")
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        name, sep, value = line.partition(":")
        if not sep:
            raise _BadRequest(400, f"malformed header: {line!r}")
        headers[name.strip().lower()] = value.strip()
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise _BadRequest(400, "bad Content-Length")
        if n < 0 or n > _MAX_BODY_BYTES:
            raise _BadRequest(413, "body too large")
        body = await reader.readexactly(n)
    return method, path, headers, body


def _response(status: int, body: bytes, content_type: str,
              extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    lines = [f"HTTP/1.1 {status} {_STATUS_TEXT.get(status, 'Unknown')}",
             f"Content-Type: {content_type}",
             f"Content-Length: {len(body)}",
             "Connection: close"]
    for k, v in (extra_headers or {}).items():
        lines.append(f"{k}: {v}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body


def _json_response(status: int, obj: Any,
                   extra_headers: Optional[Dict[str, str]] = None) -> bytes:
    return _response(status, json.dumps(obj).encode("utf-8"),
                     "application/json", extra_headers)


def _sse_frame(event: str, data: Dict[str, Any]) -> bytes:
    return (f"event: {event}\ndata: {json.dumps(data)}\n\n"
            ).encode("utf-8")


class ServingFrontend:
    """The HTTP server plus its engine bridge. Typical use::

        frontend = ServingFrontend(serving_engine, port=0)
        await frontend.start()          # binds; frontend.port is real
        ...
        await frontend.stop(drain=True)
    """

    def __init__(self, srv: Any, host: str = "127.0.0.1", port: int = 0,
                 bridge: Optional[AsyncEngineBridge] = None,
                 **bridge_kw: Any):
        self.srv = srv
        self.host = host
        self.port = port
        self.bridge = bridge if bridge is not None \
            else AsyncEngineBridge(srv, **bridge_kw)
        self._server: Optional[asyncio.AbstractServer] = None

    # -- lifecycle ------------------------------------------------------
    async def start(self) -> None:
        if not self.bridge.running:
            await self.bridge.start()
        self._server = await asyncio.start_server(
            self._handle, host=self.host, port=self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self, drain: bool = True) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self.bridge.running:
            await self.bridge.stop(drain=drain)

    # -- connection handler --------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            try:
                parsed = await _read_request(reader)
                if parsed is None:
                    return
                method, path, headers, body = parsed
                await self._route(method, path, body, reader, writer)
            except _BadRequest as e:
                writer.write(_json_response(e.status,
                                            {"error": str(e)}))
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError,
                    asyncio.IncompleteReadError):
                pass  # client went away; generate() already cancelled
            except Exception as e:  # handler bug: 500, keep serving
                try:
                    writer.write(_json_response(
                        500, {"error": f"{type(e).__name__}: {e}"}))
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError):
                    pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _route(self, method: str, path: str, body: bytes,
                     reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        if path == "/v1/generate":
            if method != "POST":
                writer.write(_json_response(405, {"error": "POST only"}))
            else:
                await self._generate(body, reader, writer)
                return
        elif path.startswith("/v1/requests/"):
            if method != "DELETE":
                writer.write(_json_response(405, {"error": "DELETE only"}))
            else:
                await self._cancel(path, writer)
        elif path == "/healthz":
            await self._healthz(writer)
        elif path == "/metrics":
            # a router fronts a FLEET: serve the merged exposition
            # (router series unlabeled, replica series replica=/role=
            # labeled, fleet_* gauges derived from merged digests)
            text = await self.bridge.call(
                lambda srv: srv.fleet.to_prometheus()
                if hasattr(srv, "fleet")
                else srv.registry.to_prometheus())
            writer.write(_response(200, text.encode("utf-8"),
                                   "text/plain; version=0.0.4"))
        else:
            writer.write(_json_response(404, {"error": f"no route "
                                              f"{method} {path}"}))
        await writer.drain()

    # -- endpoints ------------------------------------------------------
    async def _generate(self, body: bytes, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter) -> None:
        try:
            payload = json.loads(body.decode("utf-8")) if body else {}
        except (ValueError, UnicodeDecodeError):
            raise _BadRequest(400, "body must be JSON")
        if not isinstance(payload, dict):
            raise _BadRequest(400, "body must be a JSON object")
        prompt = payload.get("prompt")
        if not isinstance(prompt, list) or not prompt or \
                not all(isinstance(t, int) for t in prompt):
            raise _BadRequest(400, "prompt must be a non-empty list of "
                                   "token ids")
        kw: Dict[str, Any] = {}
        for key in ("max_new_tokens", "eos_token_id", "deadline_ms",
                    "priority", "tenant"):
            if payload.get(key) is not None:
                kw[key] = payload[key]
        unknown = set(payload) - {"prompt", "max_new_tokens",
                                  "eos_token_id", "deadline_ms",
                                  "priority", "tenant"}
        if unknown:
            raise _BadRequest(400, f"unknown fields: {sorted(unknown)}")
        try:
            req, stream = await self.bridge.submit(prompt, **kw)
        except (ValueError, TypeError) as e:
            raise _BadRequest(400, str(e))

        if req.reject_reason is not None:
            status, retry = _REJECT_STATUS.get(
                getattr(req.reject_reason, "value", str(req.reject_reason)),
                (429, True))
            extra = {}
            if retry and req.retry_after_s is not None:
                extra["Retry-After"] = f"{max(req.retry_after_s, 0.0):.3f}"
            writer.write(_json_response(status, {
                "error": "rejected",
                "reject_reason": getattr(req.reject_reason, "value",
                                         str(req.reject_reason)),
                "retry_after_s": req.retry_after_s,
                "request_id": req.request_id}, extra))
            await writer.drain()
            return

        # accepted: stream SSE. From here on, failures mean the CLIENT
        # went away — cancel engine-side and swallow the write error.
        writer.write(("HTTP/1.1 200 OK\r\n"
                      "Content-Type: text/event-stream\r\n"
                      "Cache-Control: no-store\r\n"
                      "Connection: close\r\n\r\n").encode("latin-1"))
        writer.write(_sse_frame("start", {
            "request_id": req.request_id,
            "priority_class": req.priority_class,
            "tenant": req.tenant}))
        try:
            await writer.drain()
            async for ev in stream:
                writer.write(_sse_frame(ev.get("event", "message"), ev))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError,
                asyncio.CancelledError):
            # disconnect mid-stream (or server task cancellation):
            # release the slot/pages via the engine's cancel rollback
            if self.bridge.running:
                await asyncio.shield(self.bridge.cancel(req.request_id))
            raise

    async def _cancel(self, path: str,
                      writer: asyncio.StreamWriter) -> None:
        tail = path[len("/v1/requests/"):]
        try:
            rid = int(tail)
        except ValueError:
            raise _BadRequest(400, f"bad request id {tail!r}")
        known = await self.bridge.cancel(rid)
        if known:
            writer.write(_json_response(200, {"cancelled": rid}))
        else:
            writer.write(_json_response(404, {
                "error": f"request {rid} unknown or already finished"}))

    async def _healthz(self, writer: asyncio.StreamWriter) -> None:
        def probe(srv: Any) -> Dict[str, Any]:
            # duck-typed over both a single ServingEngine and a
            # ReplicaRouter fleet (which has no scheduler/pool of its
            # own but aggregates the same numbers)
            load = getattr(srv, "_load", None)
            if hasattr(load, "state"):
                state = load.state.name.lower()
            else:
                state = getattr(srv, "health_state", "healthy")
            sched = getattr(srv, "scheduler", None)
            pool = getattr(srv, "pool", None)
            out = {
                "state": state,
                "queue_depth": sched.pending if sched is not None
                else srv.pending,
                "live_slots": srv.live_count,
                "num_slots": pool.num_slots if pool is not None
                else srv.num_slots,
                "step_id": srv.step_id,
            }
            deg = getattr(srv, "_degradation", None)
            if deg is not None:
                out["retry_after_s"] = deg.retry_after_s
            if sched is not None and hasattr(sched, "class_depths"):
                out["class_queue_depths"] = sched.class_depths()
            slo = getattr(srv, "slo", None)
            if slo is not None:
                out["class_alerts"] = dict(slo.class_alerts)
                out["goodput"] = slo.goodput()
            if hasattr(srv, "fleet_topology"):
                out["fleet"] = srv.fleet_topology()
            if hasattr(srv, "fleet"):
                # fleet health: per-replica alert states, per-role
                # queue depth/backlog, journey completeness
                out["fleet_health"] = srv.fleet.health_summary()
            return out

        info = await self.bridge.call(probe)
        if info["state"] == "overloaded":
            extra = {}
            if info.get("retry_after_s") is not None:
                extra["Retry-After"] = f"{info['retry_after_s']:.3f}"
            writer.write(_json_response(503, info, extra))
        else:
            writer.write(_json_response(200, info))
