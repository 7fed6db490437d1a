"""First-class request surface for the serving engine: sampling
parameters, streamed outputs, and request handles.

This is the stable API callers program against (the engine internals —
paged cache, scheduler, fused sampler — stay free to move underneath):

- `SamplingParams`: a frozen, validated description of HOW to decode
  one request — temperature (0 = greedy, the degenerate case, not a
  separate mode), top-k / top-p / min-p truncation, repetition and
  presence penalties, stop token-sequences, max_tokens, an optional
  seed, and an optional log-probability report width.  Attached to
  `Request`; the legacy ``Request(temperature=..., max_new_tokens=...)``
  shape lowers into an equivalent SamplingParams automatically, so
  pre-existing callers (and the pinned greedy fuzz cases) see identical
  behavior.
- **Seeded determinism**: token sampling uses a counter-based PRNG
  stream keyed on ``(seed, generated-token index)`` — no engine-global
  key is consumed — so preemption-recompute, prefix-cache replay, and
  chunked prefill reproduce the identical token sequence for
  temperature > 0 exactly as they do for greedy.  ``seed=None`` draws a
  per-request seed from the engine's own seeded stream at submit time:
  still reproducible run-to-run for a fixed submit order.
- `RequestOutput`: one *delta* of a streamed generation — the new token
  ids since the previous delta, their logprobs, the cumulative logprob,
  and (on the final delta) a ``finish_reason``.
- `RequestHandle`: returned by ``Engine.submit``.  Truthy iff the
  request was accepted (so ``if eng.submit(r):`` keeps working).
  Iterating the handle yields `RequestOutput` deltas, driving engine
  ticks on demand when none are buffered; ``drain()`` returns whatever
  is available without blocking — the poll-style surface for serving
  many streams off one engine loop.

Finish reasons:

- ``"stop"``     — EOS or one of ``SamplingParams.stop`` matched,
- ``"length"``   — ``max_tokens`` generated, or the row hit the
  engine's ``max_len`` context ceiling (``Request.truncated``),
- ``"deadline"`` — expired in queue before first admission
  (scheduler ``deadline_s``),
- ``"cancelled"`` — still queued when the engine began a graceful
  drain (``Engine.cancel_queued``); never admitted, zero tokens.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_DEADLINE = "deadline"
# cancelled-while-queued (graceful drain); a terminal state like the
# three above but kept OUT of FINISH_REASONS, which keys the per-reason
# completion counters for requests that ran
FINISH_CANCELLED = "cancelled"
FINISH_REASONS = (FINISH_STOP, FINISH_LENGTH, FINISH_DEADLINE)


def _normalize_stop(stop) -> Tuple[Tuple[int, ...], ...]:
    """Accept one token-id sequence or a collection of them; store a
    tuple of int tuples (hashable — SamplingParams stays frozen)."""
    if stop is None:
        return ()
    stop = tuple(stop)
    if not stop:
        return ()
    if isinstance(stop[0], (int, np.integer)):
        stop = (stop,)
    out = tuple(tuple(int(t) for t in seq) for seq in stop)
    for seq in out:
        if not seq:
            raise ValueError("empty stop sequence")
    return out


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How to decode one request.  Frozen + validated at construction.

    temperature: 0 => greedy (argmax — the degenerate case of the same
        pipeline, not a separate code path); > 0 scales logits before
        truncation and sampling.
    top_k: keep only the k highest logits (0 disables).
    top_p: nucleus — keep the smallest descending-probability prefix
        with mass >= top_p (1.0 disables).  Applied after top_k.
    min_p: drop tokens whose probability is below ``min_p * max_prob``
        (0 disables).  Applied after top_p.
    repetition_penalty: HF-style — logits of tokens already present in
        the prompt or output are divided (if positive) / multiplied (if
        negative) by this (1.0 disables).
    presence_penalty: subtracted from logits of tokens already
        *generated* (0 disables).
    stop: token-id sequences; generation finishes (reason "stop") when
        the output ends with any of them.  The matched tokens stay in
        the output (like EOS).
    max_tokens: generation budget (reason "length" when reached).
    seed: PRNG stream seed; None draws one from the engine's seeded
        stream at submit.  Sampling is keyed on (seed, token index), so
        a given seed reproduces its token sequence bitwise across
        preemption, prefix caching, and chunked prefill.
    logprobs: if not None, report the top-``logprobs`` (id, logprob)
        pairs per generated token alongside the chosen token's logprob
        (0 = chosen token only).  Logprobs come from the penalized,
        UN-temperature-scaled distribution — a temperature-independent
        eval surface.
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    stop: Tuple[Tuple[int, ...], ...] = ()
    max_tokens: int = 32
    seed: Optional[int] = None
    logprobs: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "stop", _normalize_stop(self.stop))
        if self.temperature < 0:
            raise ValueError(f"temperature < 0: {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k < 0: {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p not in (0, 1]: {self.top_p}")
        if not 0.0 <= self.min_p <= 1.0:
            raise ValueError(f"min_p not in [0, 1]: {self.min_p}")
        if self.repetition_penalty <= 0:
            raise ValueError(
                f"repetition_penalty <= 0: {self.repetition_penalty}")
        if self.max_tokens < 1:
            raise ValueError(f"max_tokens < 1: {self.max_tokens}")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError(f"logprobs < 0: {self.logprobs}")
        if self.seed is not None and not isinstance(
                self.seed, (int, np.integer)):
            raise ValueError(f"seed must be int or None: {self.seed!r}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass
class RequestOutput:
    """One streamed delta of a generation (see module docstring)."""
    uid: int
    new_token_ids: List[int]
    new_logprobs: List[float]
    new_topk: Optional[List[List[Tuple[int, float]]]]  # when logprobs asked
    cumulative_logprob: float
    num_generated: int            # total tokens generated so far
    finish_reason: Optional[str]  # set on the final delta only
    done: bool


class RequestHandle:
    """Streaming view of one submitted request.

    Truthy iff accepted.  Iteration yields `RequestOutput` deltas; when
    none are buffered it drives ``engine.step()`` until new tokens land
    or the request reaches a terminal state.  ``drain()`` is the
    non-blocking variant (returns possibly-empty list) for callers
    multiplexing many handles over their own engine loop.

    Deltas are derived lazily from the request's recorded state (a
    cursor over ``req.tokens``), so preemption is invisible here:
    already-streamed tokens are never re-generated (recompute restores
    the KV, not the tokens), and the stream simply continues.
    """

    _MAX_DRIVE_TICKS = 1_000_000

    def __init__(self, engine, req, accepted: bool):
        self.engine = engine
        self.req = req
        self.accepted = accepted
        self._sent = 0
        self._final = not accepted    # rejected: nothing will ever stream

    def __bool__(self) -> bool:
        return self.accepted

    def __repr__(self):
        return (f"RequestHandle(uid={self.req.uid}, "
                f"accepted={self.accepted}, status={self.req.status!r})")

    # ------------------------------------------------------------------
    def _terminal(self) -> bool:
        return self.req.done or self.req.status in (
            "expired", "rejected", "cancelled")

    def _delta(self) -> Optional[RequestOutput]:
        req = self.req
        n = len(req.tokens or ())
        terminal = self._terminal()
        if n == self._sent and not (terminal and not self._final):
            return None
        lo = self._sent
        self._sent = n
        done = terminal
        if terminal:
            self._final = True
        sp = req.sampling
        topk = None
        if sp is not None and sp.logprobs is not None \
                and req.topk_logprobs is not None:
            topk = [list(t) for t in req.topk_logprobs[lo:n]]
        return RequestOutput(
            uid=req.uid,
            new_token_ids=list(req.tokens[lo:n]),
            new_logprobs=list((req.token_logprobs or [])[lo:n]),
            new_topk=topk,
            cumulative_logprob=req.cumulative_logprob,
            num_generated=n,
            finish_reason=req.finish_reason if terminal else None,
            done=done)

    def drain(self) -> List[RequestOutput]:
        """Currently-available deltas (possibly empty); never steps the
        engine."""
        d = self._delta()
        return [d] if d is not None else []

    def __iter__(self):
        return self

    def __next__(self) -> RequestOutput:
        d = self._delta()
        if d is not None:
            return d
        if self._final or self._terminal():
            raise StopIteration
        for _ in range(self._MAX_DRIVE_TICKS):
            self.engine.step()
            d = self._delta()
            if d is not None:
                return d
            if self._terminal():
                raise StopIteration
        raise RuntimeError(           # pragma: no cover - engine wedge
            f"request {self.req.uid} made no progress in "
            f"{self._MAX_DRIVE_TICKS} ticks")
