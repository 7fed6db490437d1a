"""Admission scheduler for the continuous-batching engine.

Policy surface (the ``--scheduler`` knob):

- ``fifo``     — one class, strict arrival order.
- ``priority`` — FIFO *within* each priority class; classes served in
  ascending ``Request.priority`` (0 = most urgent).  Head-of-line rule:
  only the head of each class is eligible, so service order within a
  class always equals arrival order (the property tests pin this).

Backpressure: the queue is bounded (``max_queue``); ``submit`` refuses
beyond it — callers see the rejection immediately instead of a silently
growing tail.  An optional queue deadline expires requests that waited
longer than ``deadline_s`` before admission (they fail fast rather than
serve a dead client).

Preempted requests re-enter at the *head* of their class: they were
admitted before anything still queued there, so head placement restores
arrival order.

The scheduler also keeps the prefill/decode interleave accounting: the
engine reports every tick (``account``) how many prefill chunk steps ran
and how many rows decoded, and ``snapshot`` exposes the tick split
(prefill-only / decode-only / interleaved) plus queue-event counters —
the observability surface for tuning ``max_prefills_per_tick`` and
``prefill_chunk`` against head-of-line blocking.

All counters publish into a metrics registry (`repro_torch.obs.metrics`)
under ``sched.*`` — ``self.counters`` is a live dict-view over it, so
pre-registry call sites and tests keep their short names.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.api import FINISH_DEADLINE

POLICIES = ("fifo", "priority")

_COUNTERS = ("submitted", "queue_rejected", "requeued", "queue_expired",
             "admitted", "unpopped", "prefill_chunks", "decoded_tokens",
             "prefill_ticks", "decode_ticks", "interleaved_ticks")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    policy: str = "fifo"
    max_queue: int = 256            # bounded queue: submit rejects beyond
    max_prefills_per_tick: int = 1  # prefill/decode interleaving ratio
    deadline_s: Optional[float] = None  # max queue wait before expiry

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.max_queue < 1 or self.max_prefills_per_tick < 1:
            raise ValueError((self.max_queue, self.max_prefills_per_tick))


class Scheduler:
    def __init__(self, cfg: SchedulerConfig = SchedulerConfig(),
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        # class key is (priority, model): FIFO within a (class, tenant)
        # lane.  Single-model engines tag every request "" so behavior
        # is unchanged; the multi-model engine's per-tenant lanes mean a
        # hot tenant's backlog can never head-of-line-block another
        # tenant's admission (pop_admissible scans every lane head).
        self._classes: Dict[Tuple[int, str], deque] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.counters = self.metrics.group("sched", keys=_COUNTERS)
        self._depth = self.metrics.gauge("sched.queue_depth")

    def __len__(self) -> int:
        return sum(len(q) for q in self._classes.values())

    def _class(self, req) -> Tuple[int, str]:
        prio = req.priority if self.cfg.policy == "priority" else 0
        return (prio, getattr(req, "model", None) or "")

    def _tenant(self, req, event: str, n: int = 1) -> None:
        """Per-tenant admission accounting (`sched.tenant.<model>.*`) —
        only for tagged requests, so single-model metrics stay flat."""
        model = getattr(req, "model", None)
        if model:
            self.metrics.counter(f"sched.tenant.{model}.{event}").inc(n)

    # ------------------------------------------------------------------
    def submit(self, req, now: float) -> bool:
        """Enqueue; False = rejected by backpressure (queue full).

        ``now`` is a MONOTONIC-clock reading: it feeds the deadline
        check in ``expire`` and the queue-wait histogram, so a wall
        clock (NTP-steppable) here would corrupt both."""
        if len(self) >= self.cfg.max_queue:
            self.counters["queue_rejected"] += 1
            self._tenant(req, "rejected")
            return False
        req.submit_mono = now
        self._classes.setdefault(self._class(req), deque()).append(req)
        self.counters["submitted"] += 1
        self._tenant(req, "submitted")
        return True

    def requeue(self, req) -> None:
        """Return a preempted request to the head of its class."""
        self.counters["requeued"] += 1
        self._classes.setdefault(self._class(req), deque()).appendleft(req)

    def unpop(self, req) -> None:
        """Put back a popped head that could not actually be admitted
        (the engine's admission gate is optimistic under prefix
        sharing): restores arrival order without recording a
        preemption-style requeue.  Counts ``unpopped`` rather than
        decrementing ``admitted`` — counters stay monotone so
        ``diff_snapshots`` over a window containing an unpop can never
        report negative admissions; ``snapshot`` derives the net."""
        self.counters["unpopped"] += 1
        self._classes.setdefault(self._class(req), deque()).appendleft(req)

    def expire(self, now: float, model: Optional[str] = None) -> List:
        """Remove and return queued requests past the queue deadline.

        The deadline bounds the wait *before first admission* only: a
        preempted request re-enters with its original submit_mono, but
        it already served tokens — expiring it would silently discard
        them, so anything ever admitted is exempt.  Expired requests
        get ``finish_reason = "deadline"`` (the streaming API's
        terminal marker) here, where the expiry decision is made.
        Deadlines compare monotonic marks — a wall-clock step can
        neither spuriously expire nor immortalize a queued request.

        ``model`` filters to one tenant's lanes (None = all) — on a
        shared scheduler each sub-engine expires only its own queue."""
        if self.cfg.deadline_s is None:
            return []
        dead = []
        for key, q in self._classes.items():
            if model is not None and key[1] != model:
                continue
            kept = deque()
            for r in q:
                if getattr(r, "first_admit_mono", None) is None \
                        and now - r.submit_mono > self.cfg.deadline_s:
                    if hasattr(r, "finish_reason"):
                        r.finish_reason = FINISH_DEADLINE
                    dead.append(r)
                else:
                    kept.append(r)
            q.clear()
            q.extend(kept)
        self.counters["queue_expired"] += len(dead)
        for r in dead:
            self._tenant(r, "expired")
        return dead

    def pop_admissible(self, can_admit: Callable,
                       model: Optional[str] = None) -> Optional[object]:
        """Next request to prefill: the head of the most urgent
        non-empty class whose head fits.  Heads only — skipping past a
        blocked head would break FIFO-within-class.  ``model`` restricts
        the scan to one tenant's lanes (a sub-engine admits only its
        own traffic); ties between tenants at equal priority go to the
        lexicographically smaller tag — deterministic, and per-lane
        arrival order is what fairness tests pin, not cross-lane order.
        """
        for key in sorted(self._classes):
            if model is not None and key[1] != model:
                continue
            q = self._classes[key]
            if q and can_admit(q[0]):
                self.counters["admitted"] += 1
                req = q.popleft()
                self._tenant(req, "admitted")
                return req
        return None

    def drain(self, model: Optional[str] = None) -> List:
        """Remove and return every queued (never-admitted this pass)
        request — the graceful-shutdown path: the caller marks them
        cancelled and emits terminal deltas instead of leaving clients
        hanging.  ``model`` drains one tenant's lanes only."""
        out: List = []
        for key, q in self._classes.items():
            if model is not None and key[1] != model:
                continue
            out.extend(q)
            q.clear()
        return out

    def depth_by_class(self) -> Dict[int, int]:
        """Queue depth per priority class (tenant lanes aggregated —
        the pre-multi-model reader surface)."""
        out: Dict[int, int] = {}
        for (prio, _), q in self._classes.items():
            if q:
                out[prio] = out.get(prio, 0) + len(q)
        return out

    def depth_by_model(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for (_, model), q in self._classes.items():
            if q:
                out[model] = out.get(model, 0) + len(q)
        return out

    # ------------------------------------------------------------------
    def account(self, prefill_chunks: int, decoded_rows: int) -> None:
        """Record one engine tick's prefill/decode interleave: how many
        prefill chunk steps ran and how many rows decoded."""
        self.counters["prefill_chunks"] += prefill_chunks
        self.counters["decoded_tokens"] += decoded_rows
        if prefill_chunks and decoded_rows:
            self.counters["interleaved_ticks"] += 1
        elif prefill_chunks:
            self.counters["prefill_ticks"] += 1
        elif decoded_rows:
            self.counters["decode_ticks"] += 1
        self._depth.set(len(self))

    def snapshot(self) -> Dict[str, int]:
        """Counters + current depth, for Engine.stats()."""
        self._depth.set(len(self))
        out = dict(self.counters)
        out["queue_depth"] = len(self)
        # derived, not a counter: admissions that actually stuck
        out["admitted_net"] = out["admitted"] - out["unpopped"]
        return out
