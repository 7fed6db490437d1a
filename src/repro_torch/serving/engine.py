"""Continuous-batching serving engine over a paged KV cache (PyTorch port
of the JAX package's ``serving/engine.py``, paged decoder path).

- A fixed decode batch of ``max_concurrency`` rows; each row holds one
  sequence at its own position, K/V in fixed-size pages
  (``serving.paged_cache``), decode reading K/V through the page table
  (``kernels.paged_attention``).  When the pool is oversubscribed the
  youngest row is preempted and re-prefilled later.
- **Prefix caching** (``prefix_cache=True``): a radix tree over token-id
  page chunks maps shared prompt prefixes by reference (refcounts,
  copy-on-write on the boundary page).
- **Chunked, batched ragged prefill**: every row mid-prefill advances by
  one chunk (``prefill_chunk`` tokens, or its whole feed) per tick, all
  rows of one compile bucket in ONE ragged dispatch
  (``kernels.flash_prefill``) that writes fresh K/V straight into each
  row's private pages and reads shared prefix pages through the table.
- **Sequential scratch-cache prefill** (``batched_prefill=False``, and
  rows that cannot be bucketed: requests with ``extras``): each row
  prefills its chunk alone through the model's dense cache
  (``Model.prefill``), a batch=1 scratch of its own, and its pages
  ``[lo, hi)`` are copied into the pool; a prefix hit gathers the shared
  pages into a fresh scratch first.  Tokens equal the batched path's.
- **Sampling**: one fused sampler call per decode tick
  (``serving.sampling``), every ``SamplingParams`` knob a per-row tensor.
- Admission and retirement happen every tick through the scheduler
  (``serving.scheduler``); ``Engine.submit`` returns a ``RequestHandle``
  streaming ``RequestOutput`` deltas (``serving.api``).

PyTorch runs eagerly, so there is no ``jit``: the page pools are written
in place by the model and by the copy-on-write page copy, where the JAX
engine donates the pools to its jitted calls (``donate_argnums``) and XLA
updates them in place.

The JAX package shares one zero scratch cache among all rows because it
never mutates it; here a row takes a scratch of its own at its first
chunk and drops it on completion or preemption.

- **Speculative decoding** (``draft=(model, params)``, usually from
  ``serving.draft.build_draft``): the draft proposes ``spec_k`` tokens a
  tick and the base model verifies them in one block
  (``serving.spec_decode``); emitted tokens equal the non-speculative
  engine's.
- **Cold start** from a compressed artifact (``Engine.from_artifact``: a
  ``.hnart`` path, or ``name[@version]`` in a registry).
- **Multi-tenant hosting** (``serving.multi_model``): ``model_tag`` names
  the engine's tenant lane on a shared ``Scheduler``; ``page_allocator``
  and ``shared_pages`` bind it to a page allocator and a page pool that
  other engines share (it allocates no pool of its own); ``page_quota``
  caps the distinct pages it may hold.

A tick (``step``) runs without autograd and on the stream that was
current on the engine's device when the engine was built, whichever
thread calls it (the HTTP front end ticks from an executor thread).

Not ported yet, each raising ``NotImplementedError``: the dense-cache
backend of the non-decoder kinds and image or encoder content in
``extras`` (ROADMAP Queue A item 11; a decoder row with extras is
prefilled unbucketed and the extras are not read) and tensor-parallel
serving (item 12).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import ENGINE_PID, REQUEST_PID, Tracer
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.api import (FINISH_CANCELLED, FINISH_DEADLINE,
                                     FINISH_LENGTH, FINISH_REASONS,
                                     FINISH_STOP, RequestHandle,
                                     SamplingParams)
from repro_torch.serving.paged_cache import (TRASH_PAGE, PageAllocator,
                                             PagedKVCache)
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

# every duration and deadline comes off the monotonic clock; wall time
# survives only as the user-facing ``*_time`` stamps on Request
_now_wall = time.time
_now_mono = time.monotonic


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int = 32            # legacy mirror of sampling.max_tokens
    temperature: float = 0.0            # legacy mirror of sampling.temperature
    priority: int = 0                   # lower = more urgent
    model: Optional[str] = None         # tenant tag (multi-model engine)
    sampling: Optional[SamplingParams] = None
    # filled by the engine
    tokens: Optional[List[int]] = None
    done: bool = False
    extras: Optional[Dict[str, Any]] = None   # frames / image_embeds
    status: str = "new"
    submit_time: Optional[float] = None
    first_admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    submit_mono: Optional[float] = None
    first_admit_mono: Optional[float] = None
    first_token_mono: Optional[float] = None
    finish_mono: Optional[float] = None
    preemptions: int = 0
    truncated: bool = False
    finish_reason: Optional[str] = None
    token_logprobs: Optional[List[float]] = None
    cumulative_logprob: float = 0.0
    topk_logprobs: Optional[List[List[Tuple[int, float]]]] = None
    seed_used: Optional[int] = None

    def __post_init__(self):
        # the legacy flat knobs and SamplingParams stay coherent both ways
        if self.sampling is None:
            self.sampling = SamplingParams(temperature=self.temperature,
                                           max_tokens=self.max_new_tokens)
        else:
            self.temperature = self.sampling.temperature
            self.max_new_tokens = self.sampling.max_tokens
        if self.token_logprobs is None:
            self.token_logprobs = []
        if self.sampling.logprobs is not None and self.topk_logprobs is None:
            self.topk_logprobs = []


@dataclasses.dataclass
class _Prefill:
    """In-flight chunked prefill for one row."""
    req: Request
    feed: np.ndarray          # prompt + pre-preemption tokens
    target: int               # cached positions when complete (feed+extras)
    pos: int                  # cached positions so far (starts at prefix hit)
    cache: Any = None         # the row's batch=1 scratch cache (sequential)
    chunkable: bool = True    # bucketed decoder row without extras


def _copy_pages(pages, ck, cv, pids: torch.Tensor, lo: int, hi: int) -> None:
    """Land a scratch cache's pages ``[lo, hi)`` in the pool, in place.

    ck/cv: (nl, 1, max_len, n_kv, hd); pages {"k","v"} (nl, P, ps, n_kv,
    hd); ``pids`` (hi - lo,) the physical pages of logical pages lo..hi.
    Nothing else is written (the JAX package writes the other slots to
    the trash page so that one compile covers every chunk)."""
    if hi <= lo:
        return
    nl, _, _, hkv, hd = ck.shape
    ps = pages["k"].shape[2]
    for pool, c in ((pages["k"], ck), (pages["v"], cv)):
        pool[:, pids] = c[:, 0, lo * ps:hi * ps].reshape(
            nl, hi - lo, ps, hkv, hd).to(pool.dtype)


def _gather_prefix(pages, pids: torch.Tensor, index: int):
    """A fresh batch=1 scratch cache holding a row's (possibly shared)
    prefix K/V, gathered from the pool through ``pids`` (MAXP,), to resume
    a sequential prefill at ``index``.  Positions past the hit hold stale
    pool values: the next chunk overwrites them or they stay masked."""
    nl, _, ps, hkv, hd = pages["k"].shape
    maxp = pids.shape[0]
    return {"k": pages["k"][:, pids].reshape(nl, 1, maxp * ps, hkv, hd),
            "v": pages["v"][:, pids].reshape(nl, 1, maxp * ps, hkv, hd),
            "index": index}


def _copy_page(pages, src: int, dst: int) -> None:
    """The COW drain: page ``dst`` becomes a private replica of ``src``
    across every layer, in place."""
    for pool in (pages["k"], pages["v"]):
        pool[:, dst] = pool[:, src]


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what}: not ported yet (ROADMAP Queue A item {item})")


class Engine:
    BUCKET = 64
    # chunk buckets: small powers of two below BUCKET, then BUCKET
    # multiples — a fixed menu of prefill dispatch shapes
    _SUB_BUCKETS = (8, 16, 32)

    def __init__(self, model: Model, params, slots: int = 4,
                 max_len: int = 512, eos_id: int = 1, seed: int = 0, *,
                 device=None,
                 max_concurrency: Optional[int] = None,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 attn_impl: str = "pallas",
                 prefix_cache: bool = False,
                 prefill_chunk: Optional[int] = None,
                 batched_prefill: bool = True,
                 max_logprobs: int = 8,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 debug_leak_check: bool = False,
                 draft=None, spec_k: int = 4, spec_adaptive: bool = False,
                 mesh=None,
                 model_tag: Optional[str] = None,
                 page_allocator: Optional[PageAllocator] = None,
                 shared_pages: Optional[Dict[str, torch.Tensor]] = None,
                 page_quota: Optional[int] = None):
        """max_concurrency (alias: slots) fixes the decode batch width.

        ``device``: where the engine runs (default: the card; raises when
        there is none unless ``device="cpu"``); it must be the model's.
        ``page_size`` tokens per KV page; ``num_pages`` sizes the pool
        (default: every row provisioned to max_len; less oversubscribes
        and lets preemption absorb the overflow).  ``attn_impl``:
        "pallas" (the paged attention kernels; their plain versions on
        the CPU) or "ref" (the plain versions).  ``prefix_cache`` dedups
        shared prompt prefixes; ``prefill_chunk`` prefills long prompts N
        tokens per tick (None = whole feed).  ``batched_prefill`` (default
        on) coalesces the prefill chunks of a tick into ragged dispatches;
        off, each row prefills alone through its scratch cache, with the
        same tokens.  ``max_logprobs`` caps the
        per-token top-K logprob report; ``seed`` seeds the stream that
        assigns sampling seeds to requests that did not pin one.
        ``metrics``/``tracer``/``debug_leak_check`` as in the JAX engine.
        ``draft``: an optional ``(model, params)`` pair (typically from
        ``serving.draft.build_draft``) switching on self-speculative
        decoding: ``spec_k`` proposals a tick, verified in one block;
        ``spec_adaptive`` varies the depth within [1, spec_k] from an
        accept-rate EWMA.  Emitted tokens equal the non-speculative
        engine's.

        Multi-tenant hosting (``serving.multi_model``): ``model_tag``
        names this engine's tenant lane on a shared ``scheduler`` (a live
        ``Scheduler``, not just a config); ``page_allocator`` /
        ``shared_pages`` bind it to a shared allocator and page pool
        (``shared_pages`` is used as given: no pool is allocated);
        ``page_quota`` caps its distinct-page footprint on that pool.
        """
        dev = resolve_device(device)
        if dev.type != torch.device(model.device).type:
            raise ValueError(f"engine device {dev} is not the model's "
                             f"({model.device})")
        if mesh is not None:
            raise _not_ported("tensor-parallel serving", 12)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1: {prefill_chunk}")
        self.device = dev
        self.model = model
        self.params = params
        rows = max_concurrency if max_concurrency is not None else slots
        self.n_rows = rows
        self.eos_id = eos_id
        self.attn_impl = attn_impl
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.debug_leak_check = bool(
            debug_leak_check or os.environ.get("REPRO_DEBUG_LEAK_CHECK"))
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        # off: every row prefills alone through its scratch cache
        self.batched_prefill = bool(batched_prefill)
        self.model_tag = model_tag
        if isinstance(scheduler, Scheduler):
            self.sched = scheduler       # shared across hosted models
        else:
            self.sched = Scheduler(scheduler or SchedulerConfig(),
                                   metrics=self.metrics)
        self.rows: List[Optional[Request]] = [None] * rows
        self._row_seq = [0] * rows      # admission order, for preemption
        self._seq = 0
        self._done: List[Request] = []
        self._failed: List[Request] = []
        self._tokens = np.zeros((rows, 1), np.int64)
        self._prefilling: Dict[int, _Prefill] = {}
        # logits cover the padded vocab; the sampler sees the real one
        self._vocab = model.cfg.vocab_size
        self._sampler = sampling_lib.FusedSampler(
            rows, self._vocab, max_logprobs, metrics=self.metrics,
            tracer=self.tracer)
        self._sampler_state = self._sampler.state
        self._logprob_k = self._sampler.logprob_k
        self._auto_seeds = np.random.default_rng(seed)
        self._counts = self.metrics.group("engine", keys=(
            "ticks", "tokens", "done", "failed", "preemptions",
            "cancelled"))
        self._finish_counts = self.metrics.group("engine.finish",
                                                 keys=FINISH_REASONS)
        self._h_ttft = self.metrics.histogram("engine.ttft_s")
        self._h_qwait = self.metrics.histogram("engine.queue_wait_s")
        self._h_tick = self.metrics.histogram("engine.decode_tick_s")
        self._h_chunk = self.metrics.histogram("engine.prefill_chunk_s")
        self._pb_counts = self.metrics.group("engine.prefill_batch", keys=(
            "dispatches", "rows", "tokens", "fallback_chunks"))
        self._h_pbatch = self.metrics.histogram("engine.prefill_batch_s")
        self._leak_anomalies = self.metrics.counter("kv.leak_anomalies")
        self.last_leak_error: Optional[str] = None

        # page-aligned max_len keeps every chunk write inside the table
        self.max_len = -(-max_len // page_size) * page_size
        maxp = self.max_len // page_size
        if num_pages is None:
            num_pages = rows * maxp + 1          # +1: trash page
        self.kv = PagedKVCache(num_pages, page_size, rows, maxp,
                               prefix_cache=prefix_cache,
                               metrics=self.metrics,
                               alloc=page_allocator,
                               page_quota=page_quota)
        self._g_pages_used = self.metrics.gauge("kv.pages_in_use")
        self._g_pages_free = self.metrics.gauge("kv.pages_free")
        self._g_pages_held = self.metrics.gauge("kv.pages_held") \
            if (page_allocator is not None or page_quota is not None) \
            else None
        # written in place by decode, prefill and the COW copy
        if shared_pages is not None:
            shape, dtype = model.paged_cache_shape(num_pages, page_size)
            for name in ("k", "v"):
                t = shared_pages[name]
                if tuple(t.shape) != shape or t.dtype != dtype \
                        or t.device.type != dev.type:
                    raise ValueError(
                        f"shared_pages[{name!r}] is {tuple(t.shape)} "
                        f"{t.dtype} on {t.device}; this engine needs "
                        f"{shape} {dtype} on {dev}")
            self.pages = shared_pages
        else:
            self.pages = model.init_paged_cache(num_pages, page_size)
        # the stream every tick launches on, whichever thread ticks
        self._stream = torch.cuda.current_stream(dev) \
            if dev.type == "cuda" else None
        self.spec = None
        if draft is not None:
            from repro_torch.serving.spec_decode import SpecDecoder
            self.spec = SpecDecoder(self, draft[0], draft[1], k=spec_k,
                                    attn_impl=attn_impl,
                                    adaptive=spec_adaptive)

    @classmethod
    def from_artifact(cls, path_or_name: str, *,
                      registry_root: Optional[str] = None,
                      slots: int = 4, max_len: int = 512, eos_id: int = 1,
                      seed: int = 0, draft_policy=None, device=None,
                      **kwargs) -> "Engine":
        """Cold-start an engine from a compressed model artifact.

        path_or_name: a ``.hnart`` file path, or (with ``registry_root``)
        a registered model name, optionally ``name@version`` (the file's
        sha256 is checked).  The artifact carries the config, hash seeds
        and banks (``repro_torch.artifact``); quantized banks are
        dequantized at load.  The params land on ``device`` (default the
        card) in one copy from the file's map.  ``draft_policy`` (a
        ``CompressionPolicy``, policy-JSON path or ratio string such as
        "1/16") switches on self-speculative decoding with the draft
        derived off the same loaded params (``serving.draft``); other
        kwargs (``spec_k``, ``page_size``, ``prefix_cache``, ...) pass to
        the Engine."""
        from repro_torch.artifact import io as artifact_io
        if registry_root is not None:
            from repro_torch.artifact import registry as artifact_registry
            entry = artifact_registry.resolve(registry_root, path_or_name)
            path_or_name = entry["path"]
        _, model, params = artifact_io.load_model(path_or_name,
                                                  device=device)
        if draft_policy is not None:
            from repro_torch.serving import draft as draft_lib
            _, dmodel, dparams = draft_lib.build_draft(
                model.cfg, params, draft_policy)
            kwargs["draft"] = (dmodel, dparams)
        return cls(model, params, slots=slots, max_len=max_len,
                   eos_id=eos_id, seed=seed, device=model.device, **kwargs)

    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _extra_tokens(self, req: Request) -> int:
        if req.extras and "image_embeds" in req.extras:
            return self.model.cfg.num_image_tokens
        return 0

    def submit(self, req: Request) -> RequestHandle:
        """Enqueue a request.  Returns a ``RequestHandle``, truthy iff
        accepted (falsy: backpressure on the bounded queue, or the
        request could never fit the page pool)."""
        if req.tokens is None:
            req.tokens = []
        if self.model_tag is not None:
            req.model = self.model_tag   # tenant lane on a shared sched
        sp = req.sampling
        if sp.logprobs is not None and sp.logprobs > self._logprob_k:
            raise ValueError(
                f"logprobs={sp.logprobs} exceeds engine "
                f"max_logprobs={self._logprob_k}")
        total = len(req.prompt) + self._extra_tokens(req) + sp.max_tokens
        if not self.kv.fits_ever(total) \
                or not self.sched.submit(req, _now_mono()):
            req.status = "rejected"
            self._counts["failed"] += 1
            self._failed.append(req)
            return RequestHandle(self, req, accepted=False)
        req.submit_time = _now_wall()
        if req.seed_used is None:
            req.seed_used = int(sp.seed) if sp.seed is not None \
                else int(self._auto_seeds.integers(0, 2 ** 31 - 1))
        req.status = "queued"
        if self.tracer.enabled:
            self.tracer.track(REQUEST_PID, req.uid, f"req {req.uid}")
            self.tracer.begin(REQUEST_PID, req.uid, "request",
                              prompt_len=len(req.prompt))
            self.tracer.begin(REQUEST_PID, req.uid, "queued")
        return RequestHandle(self, req, accepted=True)

    def _free_rows(self) -> List[int]:
        return [i for i, r in enumerate(self.rows) if r is None]

    def _can_bucket(self, req: Request) -> bool:
        """Pad-and-mask bucketing (and chunking) holds for a decoder row
        without extras: pads after the prompt are causally invisible.
        Extras (image tokens, encoder frames) shift positions, so those
        rows prefill exact-length, in one step."""
        return self.model.cfg.arch_kind == "decoder" and not req.extras

    def _feed(self, req: Request) -> np.ndarray:
        """Prefill token feed: the prompt plus anything generated before a
        preemption (re-prefilling recomputes the evicted K/V)."""
        if req.tokens:
            return np.concatenate([np.asarray(req.prompt, np.int32),
                                   np.asarray(req.tokens, np.int32)])
        return np.asarray(req.prompt, np.int32)

    def _prefix_ids(self, req: Request) -> Optional[np.ndarray]:
        """Token ids for prefix matching and indexing, or None: rows with
        extras stay out of the tree (their feed ids do not spell what
        they cache)."""
        if self.kv.prefix is not None and self._can_bucket(req):
            return self._feed(req)
        return None

    def _can_admit(self, req: Request) -> bool:
        feed = len(req.prompt) + len(req.tokens or ()) \
            + self._extra_tokens(req)
        return self.kv.can_admit(feed, token_ids=self._prefix_ids(req))

    def _admit(self, now: float) -> int:
        """Advance in-flight prefills, then start new ones.  At most
        ``max_prefills_per_tick`` chunk steps run per tick; the advancing
        rows' chunks coalesce into one ragged dispatch per bucket.
        Returns the number of chunk steps taken."""
        budget = self.sched.cfg.max_prefills_per_tick
        n_inflight = len(self._prefilling)
        advancing = sorted(self._prefilling,
                           key=lambda r: self._row_seq[r])[:budget]
        chunks = self._advance_rows(advancing)
        if n_inflight > budget:
            return chunks
        admitted: List[int] = []
        while chunks + len(admitted) < budget:
            free = self._free_rows()
            if not free:
                break
            req = self.sched.pop_admissible(self._can_admit,
                                            model=self.model_tag)
            if req is None:
                break
            if not self._begin_prefill(free[0], req, now):
                # can_admit is optimistic under prefix sharing; put the
                # head back
                self.sched.unpop(req)
                break
            admitted.append(free[0])
        # same-tick admissions take their first chunk together
        self._advance_rows(admitted)
        return chunks + len(admitted)

    # ------------------------------------------------------------------
    def _begin_prefill(self, row: int, req: Request, now: float) -> bool:
        """Bind a row: allocate/share pages, and on the sequential path
        seed a scratch cache from any prefix hit.  False if the pool came
        up short (the caller re-queues)."""
        feed = self._feed(req)
        target = len(feed) + self._extra_tokens(req)
        if not self.kv.admit_row(row, target,
                                 token_ids=self._prefix_ids(req)):
            return False
        meta = self.kv.row_meta[row]
        hit = meta.hit_tokens
        chunkable = self._can_bucket(req)
        cache = None
        if hit > 0 and self.batched_prefill and chunkable:
            # the ragged kernel reads the shared prefix through the page
            # table; only the partial boundary page needs a private
            # replica (its hit bytes are read, never recomputed)
            if meta.tail_page is not None:
                dst = int(self.kv.table[row, meta.shared])
                _copy_page(self.pages, int(meta.tail_page), dst)
                self.kv.drop_tail_ref(row)
        elif hit > 0:
            # sequential path: the prefix (the boundary page from its
            # pinned source) gathered into a fresh scratch
            cache = _gather_prefix(
                self.pages, self._tensor(self.kv.gather_table(row)).long(),
                hit)
            self.kv.drop_tail_ref(row)
        self._prefilling[row] = _Prefill(req=req, feed=feed, target=target,
                                         pos=hit, cache=cache,
                                         chunkable=chunkable)
        self.rows[row] = req
        self._sampler_state.bind(row, req)
        self._seq += 1
        self._row_seq[row] = self._seq
        req.status = "prefilling"
        self._note_admitted(req, now, hit_tokens=hit)
        return True

    def _note_admitted(self, req: Request, now: float, *,
                       hit_tokens: int = 0) -> None:
        if self.tracer.enabled:
            self.tracer.end(REQUEST_PID, req.uid, "queued",
                            hit_tokens=hit_tokens)
        if req.first_admit_mono is None:
            req.first_admit_mono = now
            req.first_admit_time = _now_wall()
            self._h_qwait.observe(now - (req.submit_mono or now))

    def _chunk_shape(self, pos: int, c: int):
        """Dispatch shape for a chunk of c tokens at cached position pos:
        (start, bucket, length) with start + bucket <= max_len.  Buckets
        come from a fixed menu; when none fits the remaining room the
        window slides back (start < pos) and recomputes up to 7 cached
        positions, which land the same values."""
        room = self.max_len - pos
        if self.prefill_chunk is None and pos == 0:
            b = max(min(-(-c // self.BUCKET) * self.BUCKET, room), c)
            return 0, b, c
        for b in self._SUB_BUCKETS:
            if c <= b <= room:
                return pos, b, c
        mult = -(-c // self.BUCKET) * self.BUCKET
        if mult <= room:
            return pos, mult, c
        b = min(-(-c // 8) * 8, pos + c)     # slide-back: 8-grid bucket
        start = pos + c - b
        if start + b > self.max_len:
            raise RuntimeError(f"chunk window {start}+{b} past max_len "
                               f"{self.max_len}")
        return start, b, b

    def _advance_prefill(self, row: int) -> None:
        """One sequential chunk step: compute the next positions against
        the row's scratch cache, land their pages, and on completion
        sample the first token and hand the row to decode."""
        st = self._prefilling[row]
        req = st.req
        t0 = time.perf_counter()
        tr0 = self.tracer.now()
        pos0 = st.pos
        remaining = len(st.feed) - (st.pos if st.chunkable else 0)
        c = remaining if (self.prefill_chunk is None or not st.chunkable) \
            else min(self.prefill_chunk, remaining)
        if st.cache is None:            # the row's first chunk
            st.cache = self.model.init_cache(1, self.max_len)
        cache = st.cache
        if st.chunkable:
            start, bucket, real = self._chunk_shape(st.pos, c)
            if start != st.pos:
                # slid-back window: rewind the write index; positions
                # [start, pos) recompute to the same values
                cache = dict(cache, index=start)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, :real] = st.feed[start:start + real]
            batch = {"tokens": self._tensor(toks), "cache": cache,
                     "length": real}
        else:
            batch = {"tokens": self._tensor(st.feed[None, :].astype(
                np.int64)), "cache": cache}
            batch.update({k: self._tensor(np.asarray(v))
                          for k, v in (req.extras or {}).items()})
        logits, st.cache = self.model.prefill(self.params, batch)
        new_pos = int(st.cache["index"])
        # land the fresh positions' pages; shared prefix pages (below
        # first_private_page) are never written
        lo = max(st.pos // self.kv.page_size,
                 self.kv.first_private_page(row))
        hi = self.kv.pages_for(new_pos)
        _copy_pages(self.pages, st.cache["k"], st.cache["v"],
                    self._tensor(self.kv.table[row, lo:hi]).long(), lo, hi)
        st.pos = new_pos
        self._h_chunk.observe(time.perf_counter() - t0)
        if self.tracer.enabled:
            self.tracer.complete(REQUEST_PID, req.uid, "prefill_chunk",
                                 tr0, start=pos0, end=st.pos)
        if st.pos < st.target:
            return
        self._complete_prefill(row, logits[:, -1, :self._vocab])

    def _complete_prefill(self, row: int, last_logits) -> None:
        """Prefill complete: publish the feed's full pages for reuse,
        sample the first token off ``last_logits`` (1, V) and hand the
        row to decode."""
        st = self._prefilling.pop(row)
        req = st.req
        ids = self._prefix_ids(req)
        if ids is not None:
            full = (st.target // self.kv.page_size) * self.kv.page_size
            self.kv.index_row(row, ids, full)
        req.status = "running"
        res = self._run_sampler(last_logits, slice(row, row + 1), "prefill")
        self._commit_token(row, req, res, 0)
        self._note_first_token(req)

    def _advance_rows(self, rows_: List[int]) -> int:
        """Advance each row's prefill by one chunk step.  Chunkable rows
        coalesce into one ragged dispatch per compile bucket
        (``batched_prefill``); the others take the sequential
        scratch-cache path.  Completions run in admission order either
        way.  Returns the number of chunk steps."""
        if not (self.batched_prefill and rows_):
            for row in rows_:
                self._advance_prefill(row)
            return len(rows_)
        groups: Dict[int, List[Tuple[int, int, int]]] = {}
        for row in rows_:
            st = self._prefilling[row]
            if not st.chunkable:
                self._pb_counts["fallback_chunks"] += 1
                self._advance_prefill(row)
                continue
            remaining = len(st.feed) - st.pos
            c = remaining if self.prefill_chunk is None \
                else min(self.prefill_chunk, remaining)
            start, bucket, real = self._chunk_shape(st.pos, c)
            groups.setdefault(bucket, []).append((row, start, real))
        done: Dict[int, Any] = {}
        for bucket in sorted(groups):
            self._dispatch_prefill_batch(bucket, groups[bucket], done)
        for row in rows_:
            if row in done:
                self._complete_prefill(row, done[row])
        return len(rows_)

    def _dispatch_prefill_batch(self, bucket: int,
                                entries: List[Tuple[int, int, int]],
                                done: Dict[int, Any]) -> None:
        """ONE ragged dispatch advancing every (row, start, real) entry by
        its current chunk.  The row count pads to a power of two >= 2
        (padding rows have count 0 and are inert).  Rows that reach
        their target leave their (1, V) last-position logits in
        ``done``."""
        t0 = time.perf_counter()
        tr0 = self.tracer.now()
        n = len(entries)
        n_pad = max(2, 1 << (n - 1).bit_length())
        toks = np.zeros((n_pad, bucket), np.int64)
        starts = np.zeros((n_pad,), np.int32)
        counts = np.zeros((n_pad,), np.int32)
        wfrom = np.zeros((n_pad,), np.int32)
        tables = np.full((n_pad, self.kv.maxp), TRASH_PAGE, np.int32)
        for j, (row, start, real) in enumerate(entries):
            st = self._prefilling[row]
            toks[j, :real] = st.feed[start:start + real]
            starts[j] = start
            counts[j] = real
            # write protection: shared prefix pages (and positions below
            # this chunk's landing floor) are never rewritten
            lo = max(st.pos // self.kv.page_size,
                     self.kv.first_private_page(row))
            wfrom[j] = lo * self.kv.page_size
            tables[j] = self.kv.table[row]
        x_last = self.model.prefill_paged(
            self.params, self._tensor(toks), self.pages,
            self._tensor(tables), self._tensor(starts),
            self._tensor(counts), self._tensor(wfrom), self.attn_impl)
        dt = time.perf_counter() - t0
        self._pb_counts["dispatches"] += 1
        self._pb_counts["rows"] += n
        self._pb_counts["tokens"] += int(counts.sum())
        self._h_pbatch.observe(dt)
        if self.tracer.enabled:
            self.tracer.complete(ENGINE_PID, 0, "prefill_batch", tr0,
                                 rows=n, bucket=bucket)
        for j, (row, start, real) in enumerate(entries):
            st = self._prefilling[row]
            pos0 = st.pos
            st.pos = start + real
            self._h_chunk.observe(dt)
            if self.tracer.enabled:
                self.tracer.complete(REQUEST_PID, st.req.uid,
                                     "prefill_chunk", tr0,
                                     start=pos0, end=st.pos)
            if st.pos >= st.target:
                # Batch invariance: the LM head runs per completing row
                # at M=1, never on the batched hidden states.  cuBLAS (like
                # XLA) picks a different GEMM per M, so an M>1 head would
                # give logits that depend on which rows shared the
                # dispatch; at M=1 a row's first token does not.
                done[row] = self.model.logits_head(
                    self.params, x_last[j:j + 1])[:, -1, :self._vocab]

    def _note_first_token(self, req: Request) -> None:
        if req.first_token_mono is None:
            req.first_token_mono = _now_mono()
            req.first_token_time = _now_wall()
            self._h_ttft.observe(
                req.first_token_mono
                - (req.submit_mono or req.first_token_mono))
            if self.tracer.enabled:
                self.tracer.instant(REQUEST_PID, req.uid, "first_token")

    def _run_sampler(self, logits, sl: slice, kind: str
                     ) -> Dict[str, np.ndarray]:
        """One fused sampler call over the row slice ``sl``."""
        return self._sampler.run(logits, sl, kind)

    def _commit_token(self, row: int, req: Request,
                      res: Dict[str, np.ndarray], j: int) -> None:
        """Record row ``row``'s sampled token (index ``j`` in the sampler
        result): request output + logprobs, the sampler's counter and
        penalty masks, and the next decode feed."""
        tok = int(res["token"][j])
        lp = float(res["logprob"][j])
        self._counts["tokens"] += 1
        req.tokens.append(tok)
        req.token_logprobs.append(lp)
        req.cumulative_logprob += lp
        kk = req.sampling.logprobs
        if kk is not None and "topk_ids" in res:
            req.topk_logprobs.append(list(zip(
                res["topk_ids"][j][:kk].tolist(),
                res["topk_logprobs"][j][:kk].tolist())))
        self._sampler_state.note(row, tok)
        self._tokens[row, 0] = tok

    # ------------------------------------------------------------------
    def _history_ids(self, row: int) -> np.ndarray:
        req = self.rows[row]
        ids = np.concatenate([np.asarray(req.prompt, np.int32),
                              np.asarray(req.tokens or [], np.int32)])
        return ids[:int(self.kv.lengths[row])]

    def _publish_row(self, row: int) -> None:
        """Index everything the row cached — full pages and the partial
        boundary page — before its references drop."""
        req = self.rows[row]
        if req is None or self._prefix_ids(req) is None:
            return
        if row in self._prefilling:
            st = self._prefilling[row]
            self.kv.index_row(row, st.feed[:st.pos], st.pos)
        else:
            ids = self._history_ids(row)
            self.kv.index_row(row, ids, len(ids))

    def _preempt(self, row: int) -> None:
        req = self.rows[row]
        self._publish_row(row)
        self._prefilling.pop(row, None)
        self.rows[row] = None
        self.kv.release_row(row)
        if self.spec is not None:
            self.spec.release_row(row)
        self._sampler_state.clear(row)
        req.status = "preempted"
        req.preemptions += 1
        self._counts["preemptions"] += 1
        if self.tracer.enabled:
            self.tracer.instant(REQUEST_PID, req.uid, "preempt",
                                tokens=len(req.tokens or ()))
            self.tracer.begin(REQUEST_PID, req.uid, "queued")
        self.sched.requeue(req)

    def _finish(self, row: int, truncated: bool = False,
                reason: str = FINISH_STOP) -> None:
        req = self.rows[row]
        self._publish_row(row)
        self.rows[row] = None
        self.kv.release_row(row)
        if self.spec is not None:
            self.spec.release_row(row)
        self._sampler_state.clear(row)
        req.done = True
        req.truncated = truncated
        req.status = "done"
        req.finish_reason = reason
        self._counts["done"] += 1
        self._finish_counts[reason] += 1
        req.finish_mono = _now_mono()
        req.finish_time = _now_wall()
        if self.tracer.enabled:
            self.tracer.end(REQUEST_PID, req.uid, "request",
                            finish=reason, tokens=len(req.tokens or ()))
        self._done.append(req)

    def _ensure_room(self, active: List[int]) -> List[int]:
        """Make every active row's next write position addressable and
        privately writable (COW), preempting youngest-first on pool
        exhaustion."""
        for i in list(active):
            if self.rows[i] is None:        # preempted by an earlier row
                continue
            n0 = len(self.kv.pending_copies)
            while True:
                st = self.kv.ensure_decode_room(i)
                if st == "ok":
                    if self.tracer.enabled:
                        for src, dst in self.kv.pending_copies[n0:]:
                            self.tracer.instant(
                                REQUEST_PID, self.rows[i].uid, "cow_copy",
                                src=src, dst=dst)
                    break
                if st == "full":            # max_len hit: force-retire
                    self._finish(i, truncated=True, reason=FINISH_LENGTH)
                    break
                victims = [j for j in range(self.n_rows)
                           if self.rows[j] is not None]
                victim = max(victims, key=lambda j: self._row_seq[j])
                self._preempt(victim)
                if victim == i:
                    break
        return [i for i in active if self.rows[i] is not None]

    def _drain_cow(self) -> None:
        """Perform queued copy-on-write page copies before decode writes
        the pool (its token write must hit the private replica)."""
        for src, dst in self.kv.pending_copies:
            _copy_page(self.pages, src, dst)
        self.kv.pending_copies.clear()

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine tick: expire, admit/advance prefills, decode all
        running rows, retire.  Returns the number of rows decoded."""
        self._counts["ticks"] += 1
        tick_tr0 = self.tracer.now()
        # grad mode and the current stream are per thread: pin both, so a
        # tick on an executor thread computes what one on the main thread
        # does, with no autograd graph
        stream = torch.cuda.stream(self._stream) if self._stream is not None \
            else contextlib.nullcontext()
        with torch.no_grad(), stream:
            decoded = self._step_inner()
        self._g_pages_used.set(self.kv.alloc.num_used)
        self._g_pages_free.set(self.kv.alloc.num_free)
        if self._g_pages_held is not None:
            self._g_pages_held.set(self.kv.pages_held())
        if self.tracer.enabled:
            self.tracer.complete(ENGINE_PID, 0, "tick", tick_tr0,
                                 decoded=decoded)
        return decoded

    def _step_inner(self) -> int:
        now = _now_mono()
        for r in self.sched.expire(now, model=self.model_tag):
            r.status = "expired"
            r.finish_mono = now
            r.finish_time = _now_wall()
            self._counts["failed"] += 1
            self._finish_counts[FINISH_DEADLINE] += 1
            if self.tracer.enabled:
                self.tracer.end(REQUEST_PID, r.uid, "queued")
                self.tracer.end(REQUEST_PID, r.uid, "request",
                                finish=FINISH_DEADLINE)
            self._failed.append(r)
        chunks = self._admit(now)
        # retire before decoding: a prefill that already satisfied the
        # request must not decode a surplus token
        self._retire()
        active = [i for i, r in enumerate(self.rows)
                  if r is not None and i not in self._prefilling]
        if not active:
            self.sched.account(chunks, 0)
            return 0
        active = self._ensure_room(active)
        # drain queued COW copies in the same tick they were queued, even
        # when every row got preempted
        self._drain_cow()
        if not active:
            self.sched.account(chunks, 0)
            return 0
        t_dec = time.perf_counter()
        dec_tr0 = self.tracer.now()
        if self.spec is not None:
            # speculative tick: draft-propose + block-verify commit
            # 1..spec_k+1 tokens a row, the tokens the path below would
            # have emitted
            self.spec.tick(active)
        else:
            self._decode_tick(active)
        self._h_tick.observe(time.perf_counter() - t_dec)
        if self.tracer.enabled:
            for i in active:
                self.tracer.complete(REQUEST_PID, self.rows[i].uid,
                                     "decode_tick", dec_tr0,
                                     token=int(self._tokens[i, 0]))
        self._retire()
        self.sched.account(chunks, len(active))
        return len(active)

    def _decode_tick(self, active: List[int]) -> None:
        """One decode step over the batch and one fused sampler call."""
        table, lengths = self.kv.table, self.kv.lengths
        if self._prefilling:
            # rows mid-prefill must neither write their real pages nor
            # attend: point them at the trash page
            table = table.copy()
            lengths = lengths.copy()
            for i in self._prefilling:
                table[i, :] = TRASH_PAGE
                lengths[i] = 0
        logits = self.model.decode_paged(
            self.params, self._tensor(self._tokens), self.pages,
            self._tensor(table.astype(np.int32)),
            self._tensor(lengths.astype(np.int32)), self.attn_impl)
        # ONE fused sampler call for the whole decode batch; inactive rows
        # are sampled and discarded (their draws depend only on their own
        # (seed, pos), so discarding them disturbs nothing)
        res = self._run_sampler(logits[:, -1, :self._vocab], slice(None),
                                "decode")
        for i in active:
            self.kv.advance(i)
            self._commit_token(i, self.rows[i], res, i)

    def _stop_reason(self, r: Request) -> Optional[str]:
        if r.tokens and (r.tokens[-1] == self.eos_id
                         or sampling_lib.match_stop(r.tokens,
                                                    r.sampling.stop)):
            return FINISH_STOP
        if len(r.tokens) >= r.sampling.max_tokens:
            return FINISH_LENGTH
        return None

    def _retire(self) -> None:
        for i, r in enumerate(self.rows):
            if r is None or i in self._prefilling:
                continue
            reason = self._stop_reason(r)
            if reason is not None:
                self._finish(i, reason=reason)

    def pending(self) -> bool:
        """True while the engine has work: queued requests or occupied
        rows.  On a shared scheduler only this engine's tenant lane
        counts."""
        if self.model_tag is not None:
            depth = self.sched.depth_by_model().get(self.model_tag, 0)
        else:
            depth = len(self.sched)
        return bool(depth or any(r is not None for r in self.rows))

    def cancel_queued(self) -> List[Request]:
        """Graceful-drain entry: remove every still-queued request and mark
        it terminal with ``finish_reason="cancelled"`` (a streaming client
        sees a terminal delta); on a shared scheduler only this engine's
        tenant lane.  In-flight rows are untouched: keep ticking until
        ``pending()`` clears to let them finish."""
        now = _now_mono()
        out: List[Request] = []
        for r in self.sched.drain(model=self.model_tag):
            r.status = "cancelled"
            r.finish_reason = FINISH_CANCELLED
            r.finish_mono = now
            r.finish_time = _now_wall()
            self._counts["cancelled"] += 1
            self._counts["failed"] += 1
            if self.tracer.enabled:
                self.tracer.end(REQUEST_PID, r.uid, "queued")
                self.tracer.end(REQUEST_PID, r.uid, "request",
                                finish=FINISH_CANCELLED)
            self._failed.append(r)
            out.append(r)
        return out

    def run(self, max_ticks: int = 10000) -> List[Request]:
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.step()
            ticks += 1
        return self._done

    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        """Final bookkeeping audit: with ``debug_leak_check`` the paged
        cache's refcount audit runs over the idle pool; anomalies count
        into ``kv.leak_anomalies`` and land in ``last_leak_error``."""
        if self.debug_leak_check:
            try:
                self.kv.leak_check()
                if self.spec is not None:
                    self.spec.leak_check()   # the draft pool audits too
            except AssertionError as e:
                self._leak_anomalies.inc()
                self.last_leak_error = str(e)

    def stats(self) -> Dict[str, Any]:
        lat = [r.finish_mono - r.submit_mono for r in self._done
               if r.finish_mono and r.submit_mono]
        ttft = [r.first_token_mono - r.submit_mono for r in self._done
                if r.first_token_mono and r.submit_mono]
        out = {
            "done": len(self._done),
            "failed": len(self._failed),
            "preemptions": int(self._counts["preemptions"]),
            "tokens": sum(len(r.tokens) for r in self._done),
            "ticks": int(self._counts["ticks"]),
            "finish_reasons": dict(self._finish_counts),
            "sampler_dispatches": dict(self._sampler.dispatches),
            "sampler_time_s": round(self._sampler.time_s, 6),
        }
        if lat:
            out["latency_p50_s"] = float(np.percentile(lat, 50))
            out["latency_p99_s"] = float(np.percentile(lat, 99))
        if ttft:
            out["ttft_p50_s"] = float(np.percentile(ttft, 50))
            out["ttft_mean_s"] = float(np.mean(ttft))
        out.update(self.sched.snapshot())
        out["pages_in_use"] = self.kv.alloc.num_used
        out["pages_free"] = self.kv.alloc.num_free
        out.update(self.kv.prefix_stats())
        if self.spec is not None:
            out["spec"] = self.spec.stats()
        return out


def generate_batch(model: Model, params, prompts: List[np.ndarray],
                   max_new_tokens: int = 32, max_len: int = 512,
                   slots: int = 4, eos_id: int = 1,
                   extras: Optional[List[Dict]] = None,
                   sampling: Optional[List[SamplingParams]] = None,
                   **kwargs) -> List[List[int]]:
    """Submit every prompt, run to completion, return the tokens in prompt
    order.  ``sampling``: optional per-prompt SamplingParams (its
    max_tokens overrides ``max_new_tokens``).  The queue bound is sized
    to the batch."""
    kwargs.setdefault("scheduler",
                      SchedulerConfig(max_queue=max(len(prompts), 1)))
    eng = Engine(model, params, slots=slots, max_len=max_len, eos_id=eos_id,
                 **kwargs)
    for i, p in enumerate(prompts):
        ok = eng.submit(Request(uid=i, prompt=np.asarray(p, np.int32),
                                max_new_tokens=max_new_tokens,
                                sampling=sampling[i] if sampling else None,
                                extras=extras[i] if extras else None))
        assert ok, f"request {i} rejected (queue/pool sizing)"
    done = eng.run()
    return [r.tokens for r in sorted(done, key=lambda r: r.uid)]
