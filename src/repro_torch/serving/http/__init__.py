"""Async HTTP serving front end of the PyTorch port (stdlib asyncio, no
third-party dependencies).

- `frontend` — the server: OpenAI-style ``/v1/completions`` (JSON and
  streaming SSE), ``/v1/models``, ``/healthz``, ``/metrics``, bridging
  async connections onto the tick-driven `Engine` / `MultiModelEngine`
  via `RequestHandle` and one background tick task.
- `client`   — minimal asyncio HTTP/SSE client helpers used by the
  tests, ``chip_smoke.py`` and the streaming example (both ends are
  stdlib-only).
"""
from repro_torch.serving.http.frontend import HTTPFrontend, serve

__all__ = ["HTTPFrontend", "serve"]
