"""PyTorch port vs the JAX package: the continuous-batching paged engine.

On the request shapes of ``benchmarks/serving_bench.py`` ``_requests``,
the port's ``Engine(device="cpu")`` must give greedy tokens identical to
the JAX ``Engine`` for ``qwen3-reduced-dense``, ``qwen3-reduced-hashed``
and the same hashed at 1/8 in block mode (32 x 32 tiles,
``qwen3-reduced-block``), with equal deterministic counters (prefill
batch dispatches and rows, fallback chunks, preemptions, prefix hits).
Sampled rows are held to the JAX ``sample_tokens`` fed the JAX package's
own Gumbel field.  Batch invariance: batched and one-row-per-dispatch
prefill give identical tokens within the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from benchmarks.serving_bench import _requests
from repro.configs.reduced import reduced as jreduced
from repro.models import build as jbuild
from repro.serving import sampling as JS
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSC

import repro_torch.configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.models import build as tbuild
from repro_torch.serving import sampling as TS
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.scheduler import SchedulerConfig as TSC

COUNTERS = ("engine.prefill_batch.dispatches", "engine.prefill_batch.rows",
            "engine.prefill_batch.tokens",
            "engine.prefill_batch.fallback_chunks", "engine.preemptions",
            "engine.tokens", "engine.ticks", "prefix.hit_tokens",
            "prefix.miss_tokens", "kv.cow_copies")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module", params=["dense", "element", "block"],
                ids=["qwen3-reduced-dense", "qwen3-reduced-hashed",
                     "qwen3-reduced-block"])
def models(request):
    jc = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32")
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32")
    if request.param == "element":
        jc, tc = jc.hashed_variant(0.125), tc.hashed_variant(0.125)
    elif request.param == "block":
        # (32, 32) tiles divide every reduced shape (64, 32, 128)
        jc = jc.hashed_variant(0.125, mode="block").with_(hash_block=(32, 32))
        tc = tc.hashed_variant(0.125, mode="block").with_(hash_block=(32, 32))
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jm, jp, tbuild(tc, device="cpu"), tp


def _workload(vocab):
    """The serving bench's request shapes, plus three requests sharing
    a system prompt (prefix-cache hits)."""
    rng = np.random.default_rng(1)
    sys_prompt = rng.integers(2, vocab, size=20).astype(np.int32)
    shared = [(uid, np.concatenate([sys_prompt, rng.integers(
        2, vocab, size=5).astype(np.int32)]), 6) for uid in (8, 9, 10)]
    # the first system-prompt request lands before the bench requests,
    # the others after, once its pages are indexed
    return shared[:1] + [(r.uid, r.prompt, r.max_new_tokens)
                         for _, r in _requests(8, vocab, 6, 0.0)] + shared[1:]


def _run(engine_cls, req_cls, sc_cls, model, params, work, **kw):
    eng = engine_cls(model, params, scheduler=sc_cls(max_queue=32, **kw.pop(
        "sched", {})), **kw)
    for uid, prompt, n in work:
        assert eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                                  max_new_tokens=n))
    eng.run()
    eng.kv.leak_check()
    toks = {r.uid: list(r.tokens) for r in eng._done}
    snap = eng.metrics.snapshot()
    return toks, {k: snap.get(k) for k in COUNTERS}


@pytest.mark.parametrize("knobs,exercised", [
    (dict(max_concurrency=4, page_size=8), ()),
    (dict(max_concurrency=4, page_size=8, prefix_cache=True,
          prefill_chunk=8, sched=dict(max_prefills_per_tick=3)),
     ("prefix.hit_tokens",)),
    # oversubscribed pool: preemption + recompute
    (dict(max_concurrency=4, page_size=4, num_pages=16, prefix_cache=True,
          prefill_chunk=8), ("engine.preemptions",)),
], ids=["bench", "prefix-chunked-batched", "preempting"])
def test_greedy_tokens_and_counters_match_reference(models, knobs, exercised):
    jm, jp, tm, tp = models
    work = _workload(jm.cfg.vocab_size)
    kw = dict(max_len=64, eos_id=-1, **knobs)
    jt, jcnt = _run(JEngine, JRequest, JSC, jm, jp, work, **dict(kw))
    tt, tcnt = _run(TEngine, TRequest, TSC, tm, tp, work, device="cpu",
                    **dict(kw))
    assert tt == jt
    assert tcnt == jcnt
    assert tcnt["engine.prefill_batch.fallback_chunks"] == 0
    for key in exercised:            # the case really reaches its path
        assert tcnt[key] > 0, key


def test_batched_prefill_token_identical_to_one_row_dispatches(models):
    """Batch invariance within the port: coalescing prefill rows into
    one ragged dispatch changes no token (the LM head stays M=1)."""
    _, _, tm, tp = models
    work = _workload(tm.cfg.vocab_size)
    kw = dict(device="cpu", max_len=64, eos_id=-1, max_concurrency=4,
              page_size=8, prefill_chunk=8)
    seq, seq_cnt = _run(TEngine, TRequest, TSC, tm, tp, work,
                        sched=dict(max_prefills_per_tick=1), **dict(kw))
    bat, bat_cnt = _run(TEngine, TRequest, TSC, tm, tp, work,
                        sched=dict(max_prefills_per_tick=4), **dict(kw))
    assert bat == seq
    assert bat_cnt["engine.prefill_batch.rows"] \
        > bat_cnt["engine.prefill_batch.dispatches"]
    assert seq_cnt["engine.prefill_batch.rows"] \
        == seq_cnt["engine.prefill_batch.dispatches"]


def test_sampled_batch_matches_reference_sampler_given_same_noise():
    """Temperature + top-k (+ top-p, min-p, penalties) rows: the port's
    ``sample_tokens`` fed the JAX package's own Gumbel field picks the
    JAX ``sample_tokens`` tokens exactly."""
    rng = np.random.default_rng(5)
    b, v = 6, 96
    logits = (rng.standard_normal((b, v)) * 2).astype(np.float32)
    state = {
        "temperature": np.array([0.0, 0.8, 0.8, 1.3, 0.5, 0.8], np.float32),
        "top_k": np.array([0, 50, 5, 0, 1, 50], np.int32),
        "top_p": np.array([1.0, 1.0, 0.9, 0.7, 1.0, 1.0], np.float32),
        "min_p": np.array([0.0, 0.0, 0.0, 0.05, 0.0, 0.1], np.float32),
        "rep_pen": np.array([1.0, 1.2, 1.0, 1.0, 1.0, 1.0], np.float32),
        "pres_pen": np.array([0.0, 0.5, 0.0, 0.0, 0.0, 0.0], np.float32),
        "seed": np.array([1, 2, 3, 4, 5, 6], np.int32),
        "pos": np.array([0, 3, 7, 1, 2, 9], np.int32),
        "seen": rng.random((b, v)) < 0.1,
        "out_seen": rng.random((b, v)) < 0.05,
    }
    want = JS.sample_tokens(jnp.asarray(logits),
                            {k: jnp.asarray(a) for k, a in state.items()},
                            logprob_k=4)
    keys = jax.vmap(JS._row_key)(jnp.asarray(state["seed"]),
                                 jnp.asarray(state["pos"]))
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(
        k, (v,), jnp.float32))(keys))
    got = TS.sample_tokens(torch.from_numpy(logits),
                           {k: torch.from_numpy(np.asarray(a))
                            for k, a in state.items()},
                           logprob_k=4, noise=torch.from_numpy(noise))
    assert got["token"].tolist() == np.asarray(want["token"]).tolist()
    np.testing.assert_allclose(got["logprob"].numpy(),
                               np.asarray(want["logprob"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["topk_logprobs"].numpy(),
                               np.asarray(want["topk_logprobs"]), rtol=0,
                               atol=1e-5)


def test_port_sampling_is_reproducible_across_preemption(models):
    """The port's own noise stream is a pure function of (seed, pos): a
    sampled run on an oversubscribed pool (preempt + recompute) emits the
    tokens of a fully provisioned run."""
    _, _, tm, tp = models
    from repro_torch.serving.api import SamplingParams

    def run(num_pages):
        eng = TEngine(tm, tp, device="cpu", max_concurrency=3, max_len=48,
                      eos_id=-1, page_size=4, num_pages=num_pages,
                      scheduler=TSC(max_queue=8))
        rng = np.random.default_rng(2)
        for uid in range(5):
            eng.submit(TRequest(uid=uid, prompt=rng.integers(
                2, tm.cfg.vocab_size, size=10).astype(np.int32),
                sampling=SamplingParams(temperature=0.9, top_k=20,
                                        seed=uid, max_tokens=8)))
        eng.run()
        return {r.uid: r.tokens for r in eng._done}, \
            eng.stats()["preemptions"]
    full, p0 = run(None)
    tight, p1 = run(12)
    assert p0 == 0 and p1 > 0
    assert tight == full
