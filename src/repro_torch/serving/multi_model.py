"""Multi-model hosting (PyTorch port of the JAX package's
``serving/multi_model.py``): several registry models or variants served
off ONE shared page pool, ONE shared scheduler and one metrics registry.

This is the system-level payoff of the compression ladder: many
compressed variants fit where one dense model cannot, so one card serves
a catalog of policy rungs.  ``MultiModelEngine`` wires the existing
pieces together:

- **One physical page pool + one host allocator.**  Every hosted model
  gets its own ``Engine`` (own rows, page table, sampler, prefix tree)
  built over the SAME ``PageAllocator`` and the same ``{"k", "v"}`` pool
  tensors (``Engine(page_allocator=..., shared_pages=...)``).  Page ids
  are globally unique, so tenants never clobber each other; a per-model
  ``page_quota`` caps a tenant's distinct-page footprint (quota pressure
  evicts that tenant's own prefix cache first, then preempts its own
  youngest row, never a neighbour's).
- **One shared scheduler.**  Class keys are ``(priority, model_tag)`` and
  each sub-engine admits and expires only its own lane, so a hot
  tenant's backlog cannot head-of-line-block a quiet one.  Per-tenant
  admission counters publish as ``sched.tenant.<name>.*``.
- **Per-model metric labels.**  Each sub-engine publishes into
  ``metrics.scoped("model.<name>")``; shared series (``sched.*``, the
  pool gauges kept here) stay unscoped.
- **One pool, written in place.**  The port's dispatches write the pool
  tensors in place, so every sub-engine holds the same dict and
  ``step()`` ticks them in turn (the JAX engine, whose jitted calls
  donate the pool, hands the rebound buffers from one engine to the
  next).  Single-threaded by design: one engine touches the pool at a
  time.

**Identity.**  A hosted model's tokens equal a dedicated single-model
``Engine``'s fed the same requests in the same order: K/V does not depend
on physical page ids, sampling is counter-based per (seed, token index),
and each sub-engine draws auto-seeds from its own stream.  Cross-tenant
interference can change WHEN a token is emitted (shared-pool
preemptions), never WHICH (on the CPU; on the card a preempted row's
recompute goes through prefill-shaped products whose bf16 bits may
differ from the decode path's).

``attn_impl`` defaults to ``"pallas"``, as the port's ``Engine`` does:
the attention kernels on the card, their plain versions on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.device import resolve_device
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serving.api import RequestHandle
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.paged_cache import PageAllocator
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig


class _ModelSpec:
    __slots__ = ("name", "model", "params", "kwargs")

    def __init__(self, name, model, params, kwargs):
        self.name = name
        self.model = model
        self.params = params
        self.kwargs = kwargs


class MultiModelEngine:
    """Host several models on one shared page pool and scheduler.

    Usage::

        mm = MultiModelEngine(page_size=16, scheduler=SchedulerConfig())
        mm.add_model("dense", model_a, params_a, slots=4, max_len=256)
        mm.add_model("hashed", model_b, params_b, slots=4, max_len=256,
                     page_quota=48)
        h = mm.submit(Request(...), model="hashed")
        while mm.pending():
            mm.step()

    ``device``: where every hosted engine runs (default the card; raises
    when there is none unless ``device="cpu"``); each model must be on
    it.  ``add_model`` only records the spec; the pool, allocator and
    sub-engines are built on the first ``submit``/``step`` (so the pool
    is sized to the full roster).  Adding a model after that raises.
    """

    def __init__(self, *, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 scheduler: Optional[SchedulerConfig] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 attn_impl: str = "pallas",
                 debug_leak_check: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.page_size = page_size
        self._num_pages = num_pages
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.attn_impl = attn_impl
        self.debug_leak_check = debug_leak_check
        self.sched = Scheduler(scheduler or SchedulerConfig(),
                               metrics=self.metrics)
        self._specs: Dict[str, _ModelSpec] = {}
        self._engines: Dict[str, Engine] = {}
        self._alloc: Optional[PageAllocator] = None
        self._pool: Optional[Dict[str, torch.Tensor]] = None
        self._built = False
        self._g_pages_used = self.metrics.gauge("kv.pages_in_use")
        self._g_pages_free = self.metrics.gauge("kv.pages_free")

    # ------------------------------------------------------------------
    def add_model(self, name: str, model, params, *, slots: int = 4,
                  max_len: int = 512, eos_id: int = 1, seed: int = 0,
                  page_quota: Optional[int] = None,
                  **engine_kwargs) -> None:
        """Register a model under ``name`` (the tenant tag clients put in
        ``Request.model`` / the HTTP ``model`` field).  Extra kwargs
        (prefix_cache, prefill_chunk, draft/spec_k, ...) pass through to
        the sub-``Engine``; a speculative tenant keeps its draft's private
        pool."""
        if self._built:
            raise RuntimeError("cannot add_model after the pool is "
                               "built (first submit/step)")
        if name in self._specs:
            raise ValueError(f"model {name!r} already hosted")
        if not name or "." in name:
            # tags become metric-name components (model.<name>.engine.*)
            raise ValueError(f"bad model tag: {name!r}")
        if torch.device(model.device).type != self.device.type:
            raise ValueError(f"model {name!r} is on {model.device}, the "
                             f"engine on {self.device}")
        kwargs = dict(engine_kwargs, slots=slots, max_len=max_len,
                      eos_id=eos_id, seed=seed, page_quota=page_quota)
        self._specs[name] = _ModelSpec(name, model, params, kwargs)

    def models(self) -> List[str]:
        return list(self._specs)

    def __getitem__(self, name: str) -> Engine:
        self._ensure_built()
        return self._engines[name]

    # ------------------------------------------------------------------
    @classmethod
    def from_registry(cls, registry_root: str, names: List[str], *,
                      quotas: Optional[Dict[str, Optional[int]]] = None,
                      model_kwargs: Optional[Dict[str, Dict]] = None,
                      device=None, **kwargs) -> "MultiModelEngine":
        """Build a roster straight from the sha256 artifact registry:
        ``names`` are registered model names (``name@version`` pins a
        version; the tag strips the version).  ``quotas`` maps tag -> page
        quota; ``model_kwargs`` maps tag -> extra add_model kwargs (slots,
        max_len, seed, ...); the params land on ``device`` (default the
        card); the remaining kwargs go to the MultiModelEngine itself."""
        from repro_torch.artifact import io as artifact_io
        from repro_torch.artifact import registry as artifact_registry
        mm = cls(device=device, **kwargs)
        for spec in names:
            entry = artifact_registry.resolve(registry_root, spec)
            tag = entry["name"]
            _, model, params = artifact_io.load_model(entry["path"],
                                                      device=mm.device)
            extra = dict((model_kwargs or {}).get(tag, {}))
            extra.setdefault("page_quota", (quotas or {}).get(tag))
            mm.add_model(tag, model, params, **extra)
        return mm

    # ------------------------------------------------------------------
    def _pool_geometry(self, model, num_pages: int):
        """Shape and dtype of the model's page pool, computed without
        allocating it: hosted models must agree exactly (they share the
        physical tensors)."""
        shape, dtype = model.paged_cache_shape(num_pages, self.page_size)
        return shape, str(dtype)

    def _ensure_built(self) -> None:
        if self._built:
            return
        if not self._specs:
            raise RuntimeError("no models added")
        self._built = True
        num_pages = self._num_pages
        if num_pages is None:
            # fully provision every tenant's rows to max_len, like the
            # single-model default (+1 shared trash page); pass an
            # explicit num_pages to oversubscribe
            total = 0
            for s in self._specs.values():
                max_len = -(-s.kwargs["max_len"] // self.page_size) \
                    * self.page_size
                total += s.kwargs["slots"] * (max_len // self.page_size)
            num_pages = total + 1
        self.num_pages = num_pages
        self._alloc = PageAllocator(num_pages)
        specs = list(self._specs.values())
        geo = self._pool_geometry(specs[0].model, num_pages)
        for s in specs[1:]:
            other = self._pool_geometry(s.model, num_pages)
            if other != geo:
                raise ValueError(
                    f"page-pool geometry mismatch: {specs[0].name!r} "
                    f"{geo} vs {s.name!r} {other} — hosted models must "
                    "share (layers, page_size, kv_heads, head_dim, dtype)")
        self._pool = specs[0].model.init_paged_cache(num_pages,
                                                     self.page_size)
        for s in specs:
            eng = Engine(s.model, s.params, device=self.device,
                         page_size=self.page_size, num_pages=num_pages,
                         scheduler=self.sched, attn_impl=self.attn_impl,
                         metrics=self.metrics.scoped(f"model.{s.name}"),
                         tracer=self.tracer,
                         debug_leak_check=self.debug_leak_check,
                         model_tag=s.name, page_allocator=self._alloc,
                         shared_pages=self._pool, **s.kwargs)
            self._engines[s.name] = eng

    # ------------------------------------------------------------------
    def submit(self, req: Request,
               model: Optional[str] = None) -> RequestHandle:
        """Route a request to its tenant engine.  ``model`` (or a pre-set
        ``req.model``) names the lane; unknown names raise KeyError.  The
        returned handle drives THIS engine's step, so iterating it ticks
        every tenant."""
        self._ensure_built()
        tag = model if model is not None else req.model
        if tag not in self._engines:
            raise KeyError(f"unknown model {tag!r}; hosted: "
                           f"{list(self._engines)}")
        req.model = tag
        h = self._engines[tag].submit(req)
        h.engine = self
        return h

    def step(self) -> int:
        """One tick of every hosted engine, in the order they were added.
        Returns total rows decoded."""
        self._ensure_built()
        decoded = 0
        for eng in self._engines.values():
            decoded += eng.step()
        self._g_pages_used.set(self._alloc.num_used)
        self._g_pages_free.set(self._alloc.num_free)
        return decoded

    def pending(self) -> bool:
        self._ensure_built()
        return any(e.pending() for e in self._engines.values())

    def run(self, max_ticks: int = 10000) -> List[Request]:
        ticks = 0
        while self.pending() and ticks < max_ticks:
            self.step()
            ticks += 1
        done: List[Request] = []
        for eng in self._engines.values():
            done.extend(eng._done)
        return done

    def cancel_queued(self) -> List[Request]:
        """Graceful drain: cancel every still-queued request across all
        tenants (terminal "cancelled" deltas); in-flight rows keep
        running — tick until ``pending()`` clears."""
        self._ensure_built()
        out: List[Request] = []
        for eng in self._engines.values():
            out.extend(eng.cancel_queued())
        return out

    def shutdown(self) -> None:
        for eng in self._engines.values():
            eng.shutdown()

    def stats(self) -> Dict[str, Any]:
        self._ensure_built()
        out: Dict[str, Any] = {
            "models": {},
            "num_pages": self.num_pages,
            "pages_in_use": self._alloc.num_used,
            "pages_free": self._alloc.num_free,
        }
        for name, eng in self._engines.items():
            s = eng.stats()
            s["pages_held"] = eng.kv.pages_held()
            s["page_quota"] = eng.kv.page_quota
            out["models"][name] = s
        out.update(self.sched.snapshot())
        out["queue_depth_by_model"] = self.sched.depth_by_model()
        return out
