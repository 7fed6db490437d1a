"""PyTorch port vs the JAX package: multi-model hosting on one shared page
pool (``repro_torch.serving.multi_model``).

- On one fixed mixed workload (greedy and seeded top-p rows, two
  tenants: dense and hashed 1/4 at the reference's ``TINY`` size with
  tied embeddings, the one LM head the port has; params carried across),
  the JAX ``MultiModelEngine(attn_impl="ref")``, the
  port's ``MultiModelEngine`` and the port's dedicated engines give
  identical token ids.
- The reference's pins (``tests/test_multi_model.py``), each on the port
  alone: a page quota bounds a tenant's footprint at every tick, a
  request the quota can never hold is refused, a hot tenant's backlog
  does not block a quiet one, ``cancel_queued`` stamps the "cancelled"
  terminal, deadline expiry on the shared pool leaves both caches
  leak-free.
- The roster's checks: a pool-geometry mismatch, ``add_model`` after the
  build and bad tags raise; the geometry check allocates no pool (one
  pool for the whole roster, every tenant holding the same tensors); the
  default ``attn_impl`` is the kernels' ("pallas"); ``from_registry``
  over two port-written reduced artifacts serves their dedicated
  engines' tokens.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import build as jbuild
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Request as JRequest
from repro.serving.multi_model import MultiModelEngine as JMM
from repro.serving.scheduler import SchedulerConfig as JSC

import repro_torch.configs as TC
from repro_torch import artifact
from repro_torch.artifact import registry
from repro_torch.configs.base import ArchConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.multi_model import MultiModelEngine
from repro_torch.serving.scheduler import SchedulerConfig

_TINY = dict(name="tiny-mm", family="dense", arch_kind="decoder",
             num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, remat=False,
             dtype="float32", tie_embeddings=True)
JTINY = JArchConfig(**_TINY)
TINY = ArchConfig(**_TINY)

PAGE = 8
MAX_LEN = 64
TENANTS = ("dense", "hashed")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs():
    return (("dense", JTINY, TINY),
            ("hashed", JTINY.hashed_variant(0.25), TINY.hashed_variant(0.25)))


@pytest.fixture(scope="module")
def jax_packs():
    """{tag: (jax model, jax params, port model, port params)}: dense and
    hashed 1/4, the port's params the JAX init's bits."""
    out = {}
    for tag, jc, tc in _cfgs():
        jm = jbuild(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                               device="cpu")
        out[tag] = (jm, jp, build(tc, device="cpu"), tp)
    return out


@pytest.fixture(scope="module")
def packs():
    """The port's own seeded tenants, for the pins held on the port alone
    (no JAX model is built for them)."""
    out = {}
    for tag, _, tc in _cfgs():
        m = build(tc, device="cpu")
        out[tag] = (None, None, m, m.init(0))
    return out


def _mm(packs, *, quota=None, slots=2, deadline=None, max_queue=64):
    mm = MultiModelEngine(
        page_size=PAGE, device="cpu",
        scheduler=SchedulerConfig(max_queue=max_queue, deadline_s=deadline))
    for tag in TENANTS:
        _, _, m, p = packs[tag]
        mm.add_model(tag, m, p, slots=slots, max_len=MAX_LEN, eos_id=-1,
                     seed=0, page_quota=quota if tag == "hashed" else None)
    return mm


def _workload(n=9, seed=7):
    """(tenant, prompt, sampling kwargs): greedy and seeded top-p rows."""
    rng = np.random.default_rng(seed)
    work = []
    for i in range(n):
        prompt = rng.integers(2, TINY.vocab_size,
                              size=int(rng.integers(3, 16))).astype(np.int32)
        kw = dict(max_tokens=int(rng.integers(2, 7)))
        if i % 3:
            kw.update(temperature=0.8, top_p=0.9, seed=500 + i)
        work.append((TENANTS[i % 2 if i < 4 else int(rng.integers(2))],
                     prompt, kw))
    return work


def test_tokens_equal_jax_multi_model_and_dedicated_engines(jax_packs):
    packs = jax_packs
    work = _workload()

    jmm = JMM(page_size=PAGE, scheduler=JSC(max_queue=64), attn_impl="ref")
    for tag in TENANTS:
        jm, jp, _, _ = packs[tag]
        jmm.add_model(tag, jm, jp, slots=2, max_len=MAX_LEN, eos_id=-1,
                      seed=0)
    for uid, (tag, prompt, kw) in enumerate(work):
        assert jmm.submit(JRequest(uid=uid, prompt=prompt.copy(),
                                   sampling=JSP(**kw)), model=tag)
    want_jax = {r.uid: list(r.tokens) for r in jmm.run()}

    mm = _mm(packs)
    for uid, (tag, prompt, kw) in enumerate(work):
        assert mm.submit(Request(uid=uid, prompt=prompt.copy(),
                                 sampling=SamplingParams(**kw)), model=tag)
    got = {r.uid: list(r.tokens) for r in mm.run()}
    for tag in TENANTS:
        mm[tag].kv.leak_check()

    dedicated = {}
    for tenant in TENANTS:
        _, _, m, p = packs[tenant]
        eng = Engine(m, p, device="cpu", slots=2, max_len=MAX_LEN,
                     eos_id=-1, page_size=PAGE, seed=0,
                     scheduler=SchedulerConfig(max_queue=64))
        for uid, (tag, prompt, kw) in enumerate(work):
            if tag == tenant:
                eng.submit(Request(uid=uid, prompt=prompt.copy(),
                                   sampling=SamplingParams(**kw)))
        dedicated.update({r.uid: list(r.tokens) for r in eng.run()})
    assert len(got) == len(work)
    assert got == want_jax
    assert got == dedicated
    assert {r.model for r in mm.run()} == set(TENANTS)


@pytest.mark.parametrize("quota", [8, 5])
def test_page_quota_bounds_footprint_every_tick(packs, quota):
    """8: the reference's quota; 5: one the workload reaches (2 rows of
    22 positions want 6 pages), so rows are preempted and recomputed."""
    mm = _mm(packs, quota=quota)
    rng = np.random.default_rng(1)
    for uid in range(8):
        mm.submit(Request(
            uid=uid,
            prompt=rng.integers(2, TINY.vocab_size, size=12).astype(
                np.int32),
            max_new_tokens=10), model="hashed")
    ticks = 0
    peak = 0
    while mm.pending() and ticks < 500:
        mm.step()
        held = mm["hashed"].kv.pages_held()
        assert held <= quota, (held, quota)
        assert mm.metrics.snapshot()["model.hashed.kv.pages_held"] == held
        peak = max(peak, held)
        ticks += 1
    done = mm["hashed"]._done
    assert sorted(r.uid for r in done) == list(range(8))
    assert all(len(r.tokens) == 10 for r in done)
    assert peak == min(quota, 6)
    if quota < 6:
        assert mm.stats()["models"]["hashed"]["preemptions"] > 0
    mm["hashed"].kv.leak_check()


def test_quota_rejects_never_fitting_request(packs):
    mm = _mm(packs, quota=2)         # 2 pages can never hold 30 tokens
    ok = mm.submit(Request(
        uid=0, prompt=np.arange(2, 26, dtype=np.int32),
        max_new_tokens=6), model="hashed")
    assert not ok
    assert mm.submit(Request(
        uid=1, prompt=np.arange(2, 26, dtype=np.int32),
        max_new_tokens=6), model="dense")
    with pytest.raises(KeyError, match="unknown model"):
        mm.submit(Request(uid=2, prompt=np.arange(2, 6, dtype=np.int32)),
                  model="nope")


def test_bursty_tenants_no_head_of_line_blocking(packs):
    """A 12-deep dense backlog arriving first must not delay hashed
    admission: tenant lanes are scanned independently."""
    mm = _mm(packs, slots=2, max_queue=64)
    rng = np.random.default_rng(2)

    def burst(tag, uids):
        for uid in uids:
            mm.submit(Request(
                uid=uid,
                prompt=rng.integers(2, TINY.vocab_size, size=8).astype(
                    np.int32),
                max_new_tokens=8), model=tag)

    burst("dense", range(12))
    burst("hashed", range(100, 104))
    mm.step()
    snap = mm.metrics.snapshot()
    assert snap["sched.tenant.dense.admitted"] >= 1
    assert snap["sched.tenant.hashed.admitted"] >= 1
    mm.run()
    snap = mm.metrics.snapshot()
    for tag, n in (("dense", 12), ("hashed", 4)):
        assert snap[f"sched.tenant.{tag}.submitted"] == n
        assert snap[f"sched.tenant.{tag}.admitted"] == n
        assert snap[f"model.{tag}.engine.done"] == n
    st = mm.stats()
    assert st["models"]["dense"]["done"] == 12
    assert st["queue_depth_by_model"] == {}
    assert st["pages_in_use"] == 0


def test_cancel_queued_stamps_cancelled_terminal(packs):
    mm = _mm(packs, slots=1, max_queue=64)
    handles = [mm.submit(Request(uid=uid,
                                 prompt=np.arange(2, 10, dtype=np.int32),
                                 max_new_tokens=4),
                         model=TENANTS[uid % 2]) for uid in range(6)]
    mm.step()                            # admit one row per tenant
    cancelled = mm.cancel_queued()
    assert cancelled and all(r.status == "cancelled" and
                             r.finish_reason == "cancelled"
                             for r in cancelled)
    mm.run()
    snap = mm.metrics.snapshot()
    n_cancelled = sum(snap.get(f"model.{t}.engine.cancelled", 0)
                      for t in TENANTS)
    assert n_cancelled == len(cancelled)
    done = [r for t in TENANTS for r in mm[t]._done]
    assert len(done) + len(cancelled) == 6
    assert all(len(r.tokens) == 4 for r in done)
    # a handle iterates through the multi-model engine's step
    assert all(h.engine is mm for h in handles)
    last = [list(h) for h in handles if h.req in cancelled][0]
    assert last[-1].finish_reason == "cancelled"


def test_shared_pool_deadline_expiry_leak_free(packs):
    mm = _mm(packs, slots=1, deadline=0.0)
    for uid in range(8):
        mm.submit(Request(uid=uid,
                          prompt=np.arange(2, 12, dtype=np.int32),
                          max_new_tokens=6),
                  model=TENANTS[uid % 2])
    mm.run()
    snap = mm.metrics.snapshot()
    expired = sum(snap.get(f"sched.tenant.{t}.expired", 0)
                  for t in TENANTS)
    assert expired > 0
    for tag in TENANTS:
        mm[tag].kv.leak_check()
    assert mm._alloc.num_used == 0       # nothing retained, no prefix


@pytest.mark.parametrize("field,value", [("num_kv_heads", 4),
                                         ("head_dim", 32),
                                         ("dtype", "bfloat16")])
def test_pool_geometry_mismatch_raises(packs, field, value):
    _, _, m, p = packs["dense"]
    other_cfg = TINY.with_(**{field: value})
    if field == "num_kv_heads":
        other_cfg = other_cfg.with_(num_heads=8)
    other = build(other_cfg, device="cpu")
    mm = MultiModelEngine(page_size=PAGE, device="cpu")
    mm.add_model("a", m, p, slots=1, max_len=MAX_LEN)
    mm.add_model("b", other, other.init(0), slots=1, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="geometry mismatch"):
        mm.step()


def test_engine_refuses_shared_pages_of_another_geometry(packs):
    _, _, m, p = packs["dense"]
    pool = m.init_paged_cache(9, PAGE)
    with pytest.raises(ValueError, match="shared_pages"):
        Engine(m, p, device="cpu", slots=1, max_len=MAX_LEN, page_size=PAGE,
               num_pages=17, shared_pages=pool)


def test_add_model_after_build_and_bad_tags_raise(packs):
    _, _, m, p = packs["dense"]
    mm = MultiModelEngine(page_size=PAGE, device="cpu")
    with pytest.raises(RuntimeError, match="no models"):
        mm.step()
    for tag in ("", "a.b"):
        with pytest.raises(ValueError, match="bad model tag"):
            mm.add_model(tag, m, p)
    mm.add_model("dense", m, p, slots=1, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="already hosted"):
        mm.add_model("dense", m, p)
    assert mm.models() == ["dense"]
    mm.step()
    with pytest.raises(RuntimeError, match="after the pool is built"):
        mm.add_model("late", m, p)


def test_geometry_check_allocates_no_pool(packs, monkeypatch):
    """One pool for the whole roster: the geometry check computes shapes
    without allocating, and no sub-engine allocates a pool of its own."""
    calls = []
    for tag in TENANTS:
        m = packs[tag][2]
        orig = m.init_paged_cache

        def counted(num_pages, page_size, orig=orig, tag=tag):
            calls.append((tag, num_pages))
            return orig(num_pages, page_size)
        monkeypatch.setattr(m, "init_paged_cache", counted)
    mm = _mm(packs, slots=2)
    geo = mm._pool_geometry(packs["dense"][2], 33)
    assert geo == ((2, 33, PAGE, 2, 16), "torch.float32")
    assert calls == []
    mm.step()
    assert calls == [("dense", mm.num_pages)]
    assert mm.num_pages == 2 * 2 * (MAX_LEN // PAGE) + 1
    pool = mm["dense"].pages
    assert mm["hashed"].pages is pool
    assert mm["dense"].kv.alloc is mm["hashed"].kv.alloc
    assert mm["dense"].sched is mm["hashed"].sched is mm.sched
    # the kernels by default (their plain versions on the CPU)
    assert mm.attn_impl == "pallas"
    assert all(mm[t].attn_impl == "pallas" for t in TENANTS)


def test_from_registry_serves_two_port_artifacts(tmp_path):
    cfg = TC.reduced(TC.get("qwen3-1.7b"))
    root = str(tmp_path / "reg")
    packs = {}
    for tag, c in (("dense", cfg), ("hashed", cfg.hashed_variant(0.125))):
        m = build(c, device="cpu")
        params = m.init(0)
        path = str(tmp_path / f"{tag}.hnart")
        artifact.export_model(path, c, params)
        registry.register(root, tag, path)
        packs[tag] = (m, params)
    mm = MultiModelEngine.from_registry(
        root, ["dense", "hashed@1"], quotas={"hashed": 40},
        model_kwargs={"dense": dict(slots=2, max_len=64, eos_id=-1),
                      "hashed": dict(slots=2, max_len=64, eos_id=-1)},
        page_size=8, device="cpu")
    assert mm.models() == ["dense", "hashed"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 11, 3, 9)]
    for uid, pr in enumerate(prompts):
        assert mm.submit(Request(uid=uid, prompt=pr, max_new_tokens=4),
                         model=TENANTS[uid % 2])
    got = {r.uid: r.tokens for r in mm.run()}
    assert mm["hashed"].kv.page_quota == 40
    assert mm["dense"].kv.page_quota is None
    for i, tag in enumerate(TENANTS):
        m, params = packs[tag]
        eng = Engine(m, params, device="cpu", slots=2, max_len=64,
                     eos_id=-1, page_size=8)
        for uid in range(i, len(prompts), 2):
            eng.submit(Request(uid=uid, prompt=prompts[uid],
                               max_new_tokens=4))
        for r in eng.run():
            assert got[r.uid] == r.tokens, (tag, r.uid)
