"""Per-request span tracer with Chrome trace-event JSON export.

Events follow the Chrome trace-event format (the JSON flavor Perfetto
opens directly — https://ui.perfetto.dev): duration spans (``B``/``E``),
complete slices (``X``, with ``dur``), thread-scoped instants (``i``),
and metadata (``M``) naming processes and threads.  The engine maps:

- pid `ENGINE_PID`, tid 0 — the engine track: whole ticks, fused
  sampler dispatches, COW drains.
- pid `REQUEST_PID`, tid = request uid — one track per request:
  a ``request`` span enclosing ``queued`` spans (initial wait and every
  post-preemption re-wait), ``prefill_chunk`` and ``decode_tick``
  slices, and ``preempt`` / ``cow_copy`` / ``first_token`` instants.

Timestamps are microseconds on a ``perf_counter`` clock anchored at
tracer construction.

Overhead discipline: every recording method returns immediately when
``enabled`` is False, and ``now()`` skips the clock read — a disabled
tracer costs one attribute check per call site (the fuzz suite pins
that tracing on vs off never changes emitted tokens).
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

ENGINE_PID = 0
REQUEST_PID = 1


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.events: List[dict] = []
        self._tracks: Dict[Tuple[int, int], str] = {}
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------
    def now(self) -> float:
        """Microseconds since tracer start (0.0 when disabled — callers
        stash the value and pass it back to ``complete``)."""
        if not self.enabled:
            return 0.0
        return (time.perf_counter() - self._t0) * 1e6

    def track(self, pid: int, tid: int, name: str) -> None:
        """Name a (pid, tid) track; idempotent."""
        if not self.enabled or (pid, tid) in self._tracks:
            return
        self._tracks[(pid, tid)] = name

    def _push(self, ph: str, pid: int, tid: int, name: Optional[str],
              ts: float, args: dict, **extra) -> None:
        ev = {"ph": ph, "pid": pid, "tid": tid, "ts": ts,
              "cat": "serving"}
        if name is not None:
            ev["name"] = name
        if args:
            ev["args"] = args
        ev.update(extra)
        self.events.append(ev)

    def begin(self, pid: int, tid: int, name: str, **args) -> None:
        if not self.enabled:
            return
        self._push("B", pid, tid, name, self.now(), args)

    def end(self, pid: int, tid: int, name: Optional[str] = None,
            **args) -> None:
        if not self.enabled:
            return
        self._push("E", pid, tid, name, self.now(), args)

    def complete(self, pid: int, tid: int, name: str, start_us: float,
                 **args) -> None:
        """A finished slice: ``start_us`` from an earlier ``now()``."""
        if not self.enabled:
            return
        self._push("X", pid, tid, name, start_us, args,
                   dur=max(self.now() - start_us, 0.0))

    def instant(self, pid: int, tid: int, name: str, **args) -> None:
        if not self.enabled:
            return
        self._push("i", pid, tid, name, self.now(), args, s="t")

    # ------------------------------------------------------------------
    def to_json(self) -> dict:
        meta: List[dict] = []
        for pid, pname in ((ENGINE_PID, "engine"),
                           (REQUEST_PID, "requests")):
            meta.append({"ph": "M", "pid": pid, "tid": 0,
                         "name": "process_name",
                         "args": {"name": pname}})
        for (pid, tid), name in sorted(self._tracks.items()):
            meta.append({"ph": "M", "pid": pid, "tid": tid,
                         "name": "thread_name", "args": {"name": name}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
