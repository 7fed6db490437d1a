"""Asyncio HTTP front end over the tick-driven serving engine (PyTorch
port of the JAX package's ``serving/http/frontend.py``).

Endpoints (HTTP/1.1, ``Connection: close`` per request — the harness
and tests open one connection per request, which keeps the hand-rolled
parser honest and the drain logic trivial):

- ``POST /v1/completions`` — OpenAI-style completion over **token
  ids** (the repo has no tokenizer; ``prompt`` is a list of ints).
  Body: ``{"model": str, "prompt": [int], "max_tokens": int,
  "temperature"/"top_k"/"top_p"/"min_p"/"seed"/"stop"/"logprobs"/
  "priority": optional, "stream": bool}``.
  Non-streaming returns one JSON body; ``"stream": true`` returns
  Server-Sent Events: ``data: {json-delta}\\n\\n`` per engine delta,
  the last delta carrying ``finish_reason``, then ``data: [DONE]``.
- ``GET /v1/models`` — the hosted catalog.
- ``GET /healthz`` — liveness + drain state.
- ``GET /metrics`` — the shared registry rendered as text.

Status mapping (the scheduler's decisions become transport codes):

- 400 — malformed JSON/params, or a request that could NEVER fit the
  page pool (``fits_ever``),
- 404 — unknown model tag,
- 429 — scheduler backpressure (bounded queue refused; Retry-After: 1),
- 503 — server draining (new work refused; queued work cancelled),
- 504 — queue-deadline expiry before first admission.  On the stream
  path the status line is DELAYED until the first delta, so a request
  that dies in queue still gets a real 504 instead of a 200 + error
  frame.

Concurrency model — single event loop, engine single-threaded:

- Connection handlers NEVER touch the engine.  Submissions go through
  a queue the **tick task** drains between ticks; handlers get back
  a `RequestHandle` future.
- The tick task is the only engine caller: it submits queued work, then
  runs ``engine.step()`` in the default executor (one tick at a time —
  the loop stays responsive while the tick's kernels run), then swaps
  the tick event to wake every waiting handler.  Successive ticks may
  run on different executor threads: ``Engine.step`` pins grad mode
  (off) and the engine's CUDA stream itself, so a tick computes the same
  bits on any thread, and the kernels' launch counters are only ever
  bumped by the one thread that is ticking.
- Handlers wait on a snapshot of the tick event BEFORE draining the
  handle (snapshot-then-drain: a tick landing between the two just
  means one spurious wakeup, never a missed delta).

Graceful drain (`begin_drain`, wired to SIGINT/SIGTERM by
``launch/serve_http.py``): new requests get 503, still-queued requests
are cancelled (clients receive a terminal ``"cancelled"`` delta /
503), in-flight rows run to completion, then the tick task exits and
``wait_drained`` resolves.
"""
from __future__ import annotations

import asyncio
import json
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_DEADLINE,
                                     RequestHandle, SamplingParams)
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.multi_model import MultiModelEngine

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}

_MAX_BODY = 8 << 20


class _BadRequest(Exception):
    pass


def _json_bytes(obj) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _error_body(status: int, message: str) -> bytes:
    return _json_bytes({"error": {"code": status, "message": message}})


class HTTPFrontend:
    """One server over one `Engine` or `MultiModelEngine`."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 default_model: str = "default"):
        self.engine = engine
        self.host = host
        self.port = port           # 0 = ephemeral; real port after start()
        self._multi = isinstance(engine, MultiModelEngine)
        self._default_model = default_model
        self.metrics: MetricsRegistry = engine.metrics
        self._c_requests = self.metrics.counter("http.requests")
        self._c_streams = self.metrics.counter("http.streams")
        self._g_conns = self.metrics.gauge("http.connections")
        self._h_req = self.metrics.histogram("http.request_s")
        self._nconns = 0
        self._uid = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self._ticker: Optional[asyncio.Task] = None
        self._submit_q: deque = deque()
        self._wake = asyncio.Event()
        self._tick = asyncio.Event()
        self._draining = False
        self._drained = asyncio.Event()

    # ------------------------------------------------------------------
    # engine adaptation (single vs multi)
    def model_names(self) -> List[str]:
        if self._multi:
            return self.engine.models()
        return [self._default_model]

    def _tenant_engine(self, tag: str) -> Engine:
        return self.engine[tag] if self._multi else self.engine

    def _fits_ever(self, tag: str, total_tokens: int) -> bool:
        return self._tenant_engine(tag).kv.fits_ever(total_tokens)

    def _do_submit(self, req: Request, tag: str) -> RequestHandle:
        if self._multi:
            return self.engine.submit(req, model=tag)
        return self.engine.submit(req)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        """Bind the socket and start the tick task; ``self.port`` is the
        real port afterwards (pass port=0 for an ephemeral one)."""
        if self._multi:
            self.engine._ensure_built()   # catalog + pool before serving
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._ticker = asyncio.get_running_loop().create_task(
            self._drive())

    def begin_drain(self) -> None:
        """Stop admitting; cancel queued; let in-flight rows finish."""
        self._draining = True
        self._wake.set()

    async def wait_drained(self) -> None:
        await self._drained.wait()

    async def aclose(self) -> None:
        """Graceful shutdown: drain, stop the tick task, close the
        socket."""
        self.begin_drain()
        await self.wait_drained()
        if self._ticker is not None:
            await self._ticker
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        self.engine.shutdown()

    # ------------------------------------------------------------------
    # the tick task: the ONLY task that touches the engine
    def _notify_tick(self) -> None:
        ev, self._tick = self._tick, asyncio.Event()
        ev.set()

    async def _drive(self) -> None:
        loop = asyncio.get_running_loop()
        cancelled_sent = False
        while True:
            self._wake.clear()
            while self._submit_q:
                req, tag, fut = self._submit_q.popleft()
                if fut.cancelled():
                    continue
                try:
                    fut.set_result(self._do_submit(req, tag))
                except Exception as e:           # surface as HTTP 500
                    fut.set_exception(e)
            if self._draining and not cancelled_sent:
                cancelled_sent = True
                self.engine.cancel_queued()
                self._notify_tick()              # cancelled -> terminal
            if self.engine.pending():
                # one tick off-loop: a tick blocks for milliseconds; the
                # loop keeps accepting connections
                await loop.run_in_executor(None, self.engine.step)
                self._notify_tick()
            elif self._draining and not self._submit_q:
                self._notify_tick()
                break
            elif not self._submit_q:
                await self._wake.wait()
        self._drained.set()

    async def _submit_async(self, req: Request, tag: str) -> RequestHandle:
        fut = asyncio.get_running_loop().create_future()
        self._submit_q.append((req, tag, fut))
        self._wake.set()
        return await fut

    # ------------------------------------------------------------------
    # HTTP plumbing
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        self._nconns += 1
        self._g_conns.set(self._nconns)
        t0 = asyncio.get_running_loop().time()
        try:
            parsed = await self._read_request(reader)
            if parsed is not None:
                method, path, headers, body = parsed
                self._c_requests.inc()
                await self._route(method, path, body, writer)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._h_req.observe(asyncio.get_running_loop().time() - t0)
            self._nconns -= 1
            self._g_conns.set(self._nconns)
            try:
                if writer.can_write_eof():
                    writer.write_eof()
            except (OSError, RuntimeError):
                pass
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    @staticmethod
    async def _read_request(reader) -> Optional[Tuple[str, str, Dict, bytes]]:
        line = await reader.readline()
        if not line:
            return None
        parts = line.decode("latin1").split()
        if len(parts) < 2:
            return None
        method, path = parts[0].upper(), parts[1]
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n > _MAX_BODY:
            raise _BadRequest(f"body too large: {n}")
        body = await reader.readexactly(n) if n else b""
        return method, path, headers, body

    def _respond(self, writer, status: int, body: bytes,
                 ctype: str = "application/json",
                 extra: Tuple[str, ...] = ()) -> None:
        code_counter = self.metrics.counter(f"http.responses.{status}")
        code_counter.inc()
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
                f"Content-Type: {ctype}",
                f"Content-Length: {len(body)}",
                "Connection: close", *extra, "", ""]
        writer.write("\r\n".join(head).encode() + body)

    async def _route(self, method: str, path: str, body: bytes,
                     writer) -> None:
        path = path.split("?", 1)[0]
        if path == "/v1/completions":
            if method != "POST":
                self._respond(writer, 405, _error_body(405, "POST only"))
                return
            await self._completions(body, writer)
        elif path == "/v1/models":
            data = [{"id": n, "object": "model",
                     "owned_by": "repro"} for n in self.model_names()]
            self._respond(writer, 200,
                          _json_bytes({"object": "list", "data": data}))
        elif path == "/healthz":
            status = "draining" if self._draining else "ok"
            self._respond(writer, 200 if not self._draining else 503,
                          _json_bytes({"status": status}))
        elif path == "/metrics":
            self._respond(writer, 200, self.metrics.render().encode(),
                          ctype="text/plain; charset=utf-8")
        else:
            self._respond(writer, 404, _error_body(404,
                                                   f"no route {path}"))
        await writer.drain()

    # ------------------------------------------------------------------
    def _parse_completion(self, body: bytes) -> Tuple[Request, str, bool]:
        try:
            p = json.loads(body.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise _BadRequest(f"bad JSON: {e}")
        if not isinstance(p, dict):
            raise _BadRequest("body must be a JSON object")
        tag = p.get("model", self.model_names()[0])
        prompt = p.get("prompt")
        if not isinstance(prompt, list) or not prompt \
                or not all(isinstance(t, int) for t in prompt):
            raise _BadRequest("prompt must be a non-empty list of "
                              "token ids (ints)")
        try:
            sp = SamplingParams(
                temperature=float(p.get("temperature", 0.0)),
                top_k=int(p.get("top_k", 0)),
                top_p=float(p.get("top_p", 1.0)),
                min_p=float(p.get("min_p", 0.0)),
                stop=tuple(tuple(s) for s in p.get("stop", ()) or ()),
                max_tokens=int(p.get("max_tokens", 32)),
                seed=p.get("seed"),
                logprobs=p.get("logprobs"))
        except (TypeError, ValueError) as e:
            raise _BadRequest(f"bad sampling params: {e}")
        self._uid += 1
        req = Request(uid=self._uid,
                      prompt=np.asarray(prompt, np.int32),
                      priority=int(p.get("priority", 0)), sampling=sp)
        return req, str(tag), bool(p.get("stream", False))

    async def _completions(self, body: bytes, writer) -> None:
        try:
            req, tag, stream = self._parse_completion(body)
        except _BadRequest as e:
            self._respond(writer, 400, _error_body(400, str(e)))
            return
        if self._draining:
            self._respond(writer, 503, _error_body(
                503, "server is draining"))
            return
        if tag not in self.model_names():
            self._respond(writer, 404, _error_body(
                404, f"unknown model {tag!r}"))
            return
        total = len(req.prompt) + req.sampling.max_tokens
        if not self._fits_ever(tag, total):
            self._respond(writer, 400, _error_body(
                400, f"prompt + max_tokens = {total} tokens can never "
                     "fit the page pool"))
            return
        try:
            h = await self._submit_async(req, tag)
        except Exception as e:
            self._respond(writer, 500, _error_body(500, repr(e)))
            return
        if not h:
            self._respond(writer, 429, _error_body(
                429, "queue full, retry later"), extra=("Retry-After: 1",))
            return
        if stream:
            self._c_streams.inc()
            await self._stream_response(h, tag, writer)
        else:
            await self._json_response(h, tag, writer)

    async def _wait_terminal(self, h: RequestHandle) -> None:
        while not h._terminal():
            ev = self._tick          # snapshot BEFORE re-checking
            if h._terminal():
                break
            await ev.wait()

    @staticmethod
    def _failure_status(reason: Optional[str]) -> Optional[int]:
        if reason == FINISH_DEADLINE:
            return 504
        if reason == FINISH_CANCELLED:
            return 503
        return None

    async def _json_response(self, h: RequestHandle, tag: str,
                             writer) -> None:
        await self._wait_terminal(h)
        req = h.req
        fail = self._failure_status(req.finish_reason) \
            if not req.done else None
        if fail is not None:
            self._respond(writer, fail, _error_body(
                fail, f"request {req.finish_reason} before completion"))
            return
        body = _json_bytes({
            "id": f"cmpl-{req.uid}",
            "object": "text_completion",
            "model": tag,
            "choices": [{
                "index": 0,
                "token_ids": list(req.tokens),
                "logprobs": (list(req.token_logprobs)
                             if req.sampling.logprobs is not None
                             else None),
                "finish_reason": req.finish_reason,
            }],
            "usage": {"prompt_tokens": int(len(req.prompt)),
                      "completion_tokens": len(req.tokens),
                      "total_tokens":
                          int(len(req.prompt)) + len(req.tokens)},
        })
        self._respond(writer, 200, body)

    async def _stream_response(self, h: RequestHandle, tag: str,
                               writer) -> None:
        req = h.req
        started = False

        def frame(delta) -> bytes:
            return b"data: " + _json_bytes({
                "id": f"cmpl-{req.uid}",
                "object": "text_completion.chunk",
                "model": tag,
                "choices": [{
                    "index": 0,
                    "token_ids": list(delta.new_token_ids),
                    "finish_reason": delta.finish_reason,
                }],
            }) + b"\n\n"

        while True:
            ev = self._tick          # snapshot BEFORE draining
            deltas = h.drain()
            if deltas:
                if not started:
                    # first delta decides the status line: a request
                    # that died in queue gets a real error status
                    first = deltas[0]
                    if first.done and not first.new_token_ids:
                        fail = self._failure_status(first.finish_reason)
                        if fail is not None:
                            self._respond(writer, fail, _error_body(
                                fail, f"request {first.finish_reason} "
                                      "before first token"))
                            return
                    started = True
                    self.metrics.counter("http.responses.200").inc()
                    writer.write(
                        b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: text/event-stream\r\n"
                        b"Cache-Control: no-cache\r\n"
                        b"Connection: close\r\n\r\n")
                for d in deltas:
                    writer.write(frame(d))
                await writer.drain()
                if deltas[-1].done:
                    writer.write(b"data: [DONE]\n\n")
                    await writer.drain()
                    return
            elif h._terminal() and h._final:
                return               # everything already streamed
            else:
                await ev.wait()


def serve(engine, *, host: str = "127.0.0.1", port: int = 0,
          default_model: str = "default") -> HTTPFrontend:
    """Construct (but do not start) a frontend — call
    ``await fe.start()`` inside a running loop."""
    return HTTPFrontend(engine, host=host, port=port,
                        default_model=default_model)
