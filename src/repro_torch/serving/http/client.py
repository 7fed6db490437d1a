"""Minimal stdlib-asyncio HTTP/SSE client for the port's serving front
end (the port's own copy of the JAX package's ``serving/http/client.py``,
which imports no JAX).

Used by the tests, ``chip_smoke.py`` and the streaming example: it
speaks just enough HTTP/1.1 for the project's own server
(``Connection: close``, one request per connection) with no third-party
HTTP client.

``stream_completion`` additionally timestamps every SSE frame with the
loop's monotonic clock, which is how the arrival-process harness
measures client-side TTFT without touching server internals.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple


async def request(host: str, port: int, method: str, path: str,
                  payload: Optional[dict] = None,
                  timeout: float = 120.0) -> Tuple[int, Any]:
    """One JSON request; returns (status, parsed-body-or-text)."""
    body = json.dumps(payload).encode() if payload is not None else b""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(
            f"{method} {path} HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
        status, headers = await _read_head(reader, timeout)
        raw = await asyncio.wait_for(reader.read(), timeout)
        ctype = headers.get("content-type", "")
        out = json.loads(raw.decode()) if raw and "json" in ctype \
            else raw.decode(errors="replace")
        return status, out
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _read_head(reader, timeout: float) -> Tuple[int, Dict[str, str]]:
    line = await asyncio.wait_for(reader.readline(), timeout)
    parts = line.decode("latin1").split()
    if len(parts) < 2 or not parts[1].isdigit():
        raise ConnectionError(f"bad status line: {line!r}")
    status = int(parts[1])
    headers: Dict[str, str] = {}
    while True:
        h = await asyncio.wait_for(reader.readline(), timeout)
        if h in (b"\r\n", b"\n", b""):
            break
        k, _, v = h.decode("latin1").partition(":")
        headers[k.strip().lower()] = v.strip()
    return status, headers


async def stream_completion(host: str, port: int, payload: dict,
                            timeout: float = 120.0
                            ) -> AsyncIterator[Tuple[float, dict]]:
    """POST a ``"stream": true`` completion; yield
    ``(monotonic_time, delta_dict)`` per SSE frame (the terminal
    ``[DONE]`` sentinel is consumed, not yielded).  A non-200 status
    raises ``HTTPStreamError`` carrying the code and error body."""
    body = json.dumps(dict(payload, stream=True)).encode()
    reader, writer = await asyncio.open_connection(host, port)
    loop = asyncio.get_running_loop()
    try:
        writer.write(
            f"POST /v1/completions HTTP/1.1\r\nHost: {host}\r\n"
            f"Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)
        await writer.drain()
        status, _ = await _read_head(reader, timeout)
        if status != 200:
            raw = await asyncio.wait_for(reader.read(), timeout)
            raise HTTPStreamError(status, raw.decode(errors="replace"))
        while True:
            line = await asyncio.wait_for(reader.readline(), timeout)
            if not line:
                return
            line = line.strip()
            if not line or not line.startswith(b"data: "):
                continue
            data = line[len(b"data: "):]
            if data == b"[DONE]":
                return
            yield loop.time(), json.loads(data.decode())
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


class HTTPStreamError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"HTTP {status}: {body}")
        self.status = status
        self.body = body


async def collect_stream(host: str, port: int, payload: dict,
                         timeout: float = 120.0) -> Dict[str, Any]:
    """Convenience: run a streamed completion to the end, returning
    ``{"tokens": [...], "finish_reason": str, "ttft_s": float,
    "e2e_s": float}`` (client-side timings)."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    tokens: List[int] = []
    ttft: Optional[float] = None
    finish: Optional[str] = None
    async for t, delta in stream_completion(host, port, payload, timeout):
        ch = delta["choices"][0]
        if ch["token_ids"] and ttft is None:
            ttft = t - t0
        tokens.extend(ch["token_ids"])
        if ch["finish_reason"] is not None:
            finish = ch["finish_reason"]
    return {"tokens": tokens, "finish_reason": finish,
            "ttft_s": ttft, "e2e_s": loop.time() - t0}
