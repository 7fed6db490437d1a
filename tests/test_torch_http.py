"""PyTorch port vs the JAX package: the asyncio HTTP front end
(``repro_torch.serving.http``) over the port's ``Engine`` and
``MultiModelEngine``.

- Streaming SSE and plain JSON completions through the server,
  interleaved, give the token ids of direct submission to an
  identically-seeded port ``Engine``, and those of the JAX ``Engine`` on
  the same params (greedy and seeded top-p rows).  Over a two-tenant
  ``MultiModelEngine`` the completions give direct submission's tokens.
- The reference's pins (``tests/test_http.py``): unknown model -> 404, bad
  payload or a never-fitting prompt -> 400, wrong method -> 405, full
  queue -> 429 with Retry-After, queue-deadline expiry -> 504 on both
  response paths, the graceful drain (503 on /healthz and new work,
  queued requests cancelled, in-flight rows finished), the ``http.*``
  counters and the JSON envelope.
- The server ticks on executor threads: one tick there gives the main
  thread's logits bitwise, with no autograd graph even where the caller's
  params require grad and the thread's grad mode is on.

Every asynchronous test is bounded by ``asyncio.wait_for``, so a hang
fails in seconds.
"""
import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.models import build as jbuild
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSC

from repro_torch.configs.base import ArchConfig
from repro_torch.interop import params_from_numpy
from repro_torch.models import build
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.http import HTTPFrontend, serve
from repro_torch.serving.http import client as http_client
from repro_torch.serving.multi_model import MultiModelEngine
from repro_torch.serving.scheduler import SchedulerConfig

_TINY = dict(name="tiny-http", family="dense", arch_kind="decoder",
             num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256, remat=False,
             dtype="float32", tie_embeddings=True)
JTINY = JArchConfig(**_TINY)
TINY = ArchConfig(**_TINY)

PAGE = 8
MAX_LEN = 64
LIMIT_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def tiny():
    """(None, None, port model, port params): the port's own seeded init,
    for the tests held on the port alone (no JAX model is built)."""
    m = build(TINY, device="cpu")
    return None, None, m, m.init(0)


@pytest.fixture(scope="module")
def jax_tiny():
    """(jax model, jax params, port model, port params), one JAX init."""
    jm = jbuild(JTINY)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), TINY, device="cpu")
    return jm, jp, build(TINY, device="cpu"), tp


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _engine(tiny, **kw):
    _, _, m, params = tiny
    kw.setdefault("max_concurrency", 2)
    kw.setdefault("scheduler", SchedulerConfig(max_queue=32))
    return Engine(m, params, device="cpu", max_len=MAX_LEN, eos_id=-1,
                  page_size=PAGE, **kw)


def _workload(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = [int(x) for x in rng.integers(
            2, TINY.vocab_size, size=int(rng.integers(3, 14)))]
        if i % 3 == 0:
            sp = dict(temperature=0.0)
        else:
            sp = dict(temperature=0.8, top_p=0.9, seed=100 + i)
        out.append((prompt, dict(sp, max_tokens=int(rng.integers(2, 7)))))
    return out


def _sp(kw, cls=SamplingParams):
    return cls(temperature=kw["temperature"], top_p=kw.get("top_p", 1.0),
               seed=kw.get("seed"), max_tokens=kw["max_tokens"])


async def _fire(host, port, work, model):
    """Every request at once, SSE and JSON interleaved: {uid: tokens}."""
    tasks = []
    for uid, (prompt, kw) in enumerate(work):
        payload = dict(model=model, prompt=prompt, **kw)
        if uid % 2:
            tasks.append(http_client.collect_stream(host, port, payload))
        else:
            tasks.append(http_client.request(host, port, "POST",
                                             "/v1/completions", payload))
    results = await asyncio.gather(*tasks)
    got = {}
    for uid, r in enumerate(results):
        if uid % 2:
            assert r["finish_reason"] == "length"
            got[uid] = r["tokens"]
        else:
            status, body = r
            assert status == 200, body
            assert body["model"] == model
            got[uid] = body["choices"][0]["token_ids"]
            assert body["usage"]["completion_tokens"] == len(got[uid])
    return got


@pytest.fixture(scope="module")
def jax_tokens(jax_tiny):
    """The JAX Engine's tokens on the shared workload, same params."""
    jm, jp, _, _ = jax_tiny
    eng = JEngine(jm, jp, max_concurrency=2, max_len=MAX_LEN, eos_id=-1,
                  page_size=PAGE, scheduler=JSC(max_queue=32))
    for uid, (prompt, kw) in enumerate(_workload(6)):
        eng.submit(JRequest(uid=uid, prompt=np.array(prompt, np.int32),
                            sampling=_sp(kw, JSP)))
    return {r.uid: list(r.tokens) for r in eng.run()}


def test_http_tokens_equal_direct_engine_and_jax_engine(jax_tiny,
                                                        jax_tokens):
    tiny = jax_tiny
    work = _workload(6)
    ref = _engine(tiny)
    for uid, (prompt, kw) in enumerate(work):
        ref.submit(Request(uid=uid, prompt=np.array(prompt, np.int32),
                           sampling=_sp(kw)))
    want = {r.uid: list(r.tokens) for r in ref.run()}
    assert want == jax_tokens

    async def go():
        fe = HTTPFrontend(_engine(tiny), port=0, default_model="tiny")
        await fe.start()
        got = await _fire(fe.host, fe.port, work, "tiny")
        await fe.aclose()
        return got

    assert _run(go()) == want


def test_http_multi_model_tokens_equal_direct_submission(tiny):
    _, _, m, p = tiny
    hcfg = TINY.hashed_variant(0.25)
    hm = build(hcfg, device="cpu")
    hp = hm.init(0)

    def roster():
        mm = MultiModelEngine(page_size=PAGE, device="cpu",
                              scheduler=SchedulerConfig(max_queue=32))
        mm.add_model("dense", m, p, slots=2, max_len=MAX_LEN, eos_id=-1)
        mm.add_model("hashed", hm, hp, slots=2, max_len=MAX_LEN, eos_id=-1,
                      page_quota=10)
        return mm

    work = _workload(8, seed=3)
    tags = ["dense", "hashed"] * 4
    ref = roster()
    for uid, (prompt, kw) in enumerate(work):
        ref.submit(Request(uid=uid, prompt=np.array(prompt, np.int32),
                           sampling=_sp(kw)), model=tags[uid])
    ref.run()
    want = {tag: {r.uid: list(r.tokens) for r in ref[tag]._done}
            for tag in ("dense", "hashed")}

    async def go():
        fe = serve(roster(), port=0)
        await fe.start()
        status, models = await http_client.request(fe.host, fe.port, "GET",
                                                   "/v1/models")
        got = {}
        for tag in ("dense", "hashed"):
            mine = [(uid, w) for uid, w in enumerate(work) if tags[uid] == tag]
            toks = await _fire(fe.host, fe.port, [w for _, w in mine], tag)
            got[tag] = {uid: toks[j] for j, (uid, _) in enumerate(mine)}
        st = fe.engine.stats()
        await fe.aclose()
        return status, models, got, st

    status, models, got, st = _run(go())
    assert status == 200
    assert [d["id"] for d in models["data"]] == ["dense", "hashed"]
    assert got == want
    assert st["models"]["hashed"]["page_quota"] == 10
    assert st["pages_in_use"] == 0


def test_http_error_codes(tiny):
    async def go():
        fe = HTTPFrontend(_engine(tiny), port=0, default_model="tiny")
        await fe.start()
        h, p = fe.host, fe.port
        out = {}
        out["models"] = await http_client.request(h, p, "GET", "/v1/models")
        out["404"] = await http_client.request(
            h, p, "POST", "/v1/completions",
            dict(model="nope", prompt=[2, 3], max_tokens=2))
        out["400_prompt"] = await http_client.request(
            h, p, "POST", "/v1/completions",
            dict(model="tiny", prompt="not token ids", max_tokens=2))
        out["400_json"] = await http_client.request(
            h, p, "POST", "/v1/completions", [1, 2])
        out["400_fits"] = await http_client.request(
            h, p, "POST", "/v1/completions",
            dict(model="tiny", prompt=[2] * (MAX_LEN + 8), max_tokens=2))
        out["405"] = await http_client.request(h, p, "GET",
                                               "/v1/completions")
        out["health"] = await http_client.request(h, p, "GET", "/healthz")
        out["metrics"] = await http_client.request(h, p, "GET", "/metrics")
        out["lost"] = await http_client.request(h, p, "GET", "/nowhere")
        await fe.aclose()
        return out

    out = _run(go())
    assert out["models"][0] == 200
    assert [m["id"] for m in out["models"][1]["data"]] == ["tiny"]
    assert out["404"][0] == 404
    assert out["400_prompt"][0] == 400
    assert out["400_json"][0] == 400
    assert out["400_fits"][0] == 400
    assert "never" in out["400_fits"][1]["error"]["message"]
    assert out["405"][0] == 405
    assert out["health"] == (200, {"status": "ok"})
    assert out["metrics"][0] == 200 and "http.requests" in out["metrics"][1]
    assert out["lost"][0] == 404


def test_http_backpressure_429(tiny):
    """A full bounded queue refuses with 429 + Retry-After; accepted
    requests still finish."""
    async def go():
        fe = HTTPFrontend(
            _engine(tiny, max_concurrency=1,
                    scheduler=SchedulerConfig(max_queue=1)),
            port=0, default_model="tiny")
        await fe.start()
        payload = dict(model="tiny", prompt=[2, 3, 4, 5, 6],
                       max_tokens=12, temperature=0.0)
        tasks = [http_client.request(fe.host, fe.port, "POST",
                                     "/v1/completions", payload)
                 for _ in range(8)]
        results = await asyncio.gather(*tasks)
        snap = fe.metrics.snapshot()
        await fe.aclose()
        return results, snap

    results, snap = _run(go())
    codes = sorted(s for s, _ in results)
    assert 429 in codes, codes
    ok = [b for s, b in results if s == 200]
    assert ok and all(len(b["choices"][0]["token_ids"]) == 12 for b in ok)
    assert snap["http.responses.429"] == codes.count(429)


async def _stream_status(host, port, payload):
    try:
        await http_client.collect_stream(host, port, payload)
        return 200
    except http_client.HTTPStreamError as e:
        return e.status


def test_http_deadline_504(tiny):
    """Queue-deadline expiry surfaces as 504 on both response paths."""
    async def go():
        fe = HTTPFrontend(
            _engine(tiny, max_concurrency=1,
                    scheduler=SchedulerConfig(max_queue=16,
                                              deadline_s=0.0)),
            port=0, default_model="tiny")
        await fe.start()
        payload = dict(model="tiny", prompt=[2, 3, 4], max_tokens=6,
                       temperature=0.0)
        tasks = [http_client.request(fe.host, fe.port, "POST",
                                     "/v1/completions", payload)
                 for _ in range(4)]
        streams = [asyncio.create_task(_stream_status(
            fe.host, fe.port, payload)) for _ in range(3)]
        results = await asyncio.gather(*tasks)
        s_codes = [await t for t in streams]
        await fe.aclose()
        return [s for s, _ in results], s_codes

    codes, s_codes = _run(go())
    assert 504 in codes + s_codes, (codes, s_codes)
    assert all(c in (200, 504) for c in codes + s_codes), (codes, s_codes)


def test_http_graceful_drain(tiny):
    """begin_drain: health flips to 503, queued requests come back
    cancelled (503), in-flight rows run to completion, the tick task exits."""
    async def go():
        fe = HTTPFrontend(
            _engine(tiny, max_concurrency=1,
                    scheduler=SchedulerConfig(max_queue=16)),
            port=0, default_model="tiny")
        await fe.start()
        payload = dict(model="tiny", prompt=[2, 3, 4, 5], max_tokens=16,
                       temperature=0.0)
        tasks = [asyncio.create_task(
            http_client.request(fe.host, fe.port, "POST",
                                "/v1/completions", payload))
            for _ in range(3)]
        for _ in range(2000):
            await asyncio.sleep(0.005)
            if fe.metrics.snapshot().get("sched.admitted", 0) >= 1:
                break
        fe.begin_drain()
        health = await http_client.request(fe.host, fe.port, "GET",
                                           "/healthz")
        late = await http_client.request(
            fe.host, fe.port, "POST", "/v1/completions", payload)
        results = await asyncio.gather(*tasks)
        await fe.wait_drained()
        snap = fe.metrics.snapshot()
        await fe.aclose()
        return health, late, results, snap

    health, late, results, snap = _run(go())
    assert health[0] == 503
    assert late[0] == 503
    codes = sorted(s for s, _ in results)
    assert codes.count(200) >= 1 and set(codes) <= {200, 503}, codes
    done_tokens = [b["choices"][0]["token_ids"]
                   for s, b in results if s == 200]
    assert all(len(t) == 16 for t in done_tokens)
    assert snap.get("engine.cancelled", 0) == codes.count(503)


def test_http_request_counters(tiny):
    async def go():
        fe = HTTPFrontend(_engine(tiny), port=0, default_model="tiny")
        await fe.start()
        payload = dict(model="tiny", prompt=[2, 3, 4], max_tokens=3,
                       temperature=0.0)
        await http_client.request(fe.host, fe.port, "POST",
                                  "/v1/completions", payload)
        await http_client.collect_stream(fe.host, fe.port, payload)
        await http_client.request(fe.host, fe.port, "GET", "/v1/models")
        snap = fe.metrics.snapshot()
        await fe.aclose()
        return snap

    snap = _run(go())
    assert snap["http.requests"] == 3
    assert snap["http.streams"] == 1
    assert snap["http.responses.200"] == 3
    assert snap["engine.done"] == 2


def test_http_json_body_shape(tiny):
    async def go():
        fe = HTTPFrontend(_engine(tiny), port=0, default_model="tiny")
        await fe.start()
        status, body = await http_client.request(
            fe.host, fe.port, "POST", "/v1/completions",
            dict(model="tiny", prompt=[5, 6, 7], max_tokens=4,
                 temperature=0.0, logprobs=2))
        await fe.aclose()
        return status, body

    status, body = _run(go())
    assert status == 200
    assert body["object"] == "text_completion"
    assert body["model"] == "tiny"
    assert body["id"].startswith("cmpl-")
    ch = body["choices"][0]
    assert ch["finish_reason"] == "length"
    assert len(ch["token_ids"]) == 4
    assert len(ch["logprobs"]) == 4
    assert body["usage"] == {"prompt_tokens": 3, "completion_tokens": 4,
                             "total_tokens": 7}


def _capture(eng):
    """Every sampler call's logits, whether they carry a graph, and the
    thread that made them."""
    seen = []
    orig = eng._sampler.run

    def run(logits, sl, kind):
        seen.append((kind, logits.detach().clone(), logits.requires_grad,
                     threading.current_thread().name))
        return orig(logits, sl, kind)
    eng._sampler.run = run
    return seen


def test_tick_on_an_executor_thread_gives_the_main_threads_bits(tiny):
    """Params that require grad, grad mode on in both threads: a tick's
    logits are bitwise equal whichever thread ticks, and carry no graph."""
    _, _, m, params = tiny
    grad_params = _requires_grad(params)
    work = _workload(4, seed=9)

    def make():
        eng = Engine(m, grad_params, device="cpu", max_concurrency=2,
                     max_len=MAX_LEN, eos_id=-1, page_size=PAGE,
                     scheduler=SchedulerConfig(max_queue=8))
        for uid, (prompt, kw) in enumerate(work):
            eng.submit(Request(uid=uid, prompt=np.array(prompt, np.int32),
                               sampling=_sp(kw)))
        return eng, _capture(eng)

    main_eng, main_seen = make()
    with torch.enable_grad():
        while main_eng.pending():
            main_eng.step()

    async def off_loop():
        eng, seen = make()
        loop = asyncio.get_running_loop()

        def tick():
            torch.set_grad_enabled(True)     # a fresh thread's default
            return eng.step()
        while eng.pending():
            await loop.run_in_executor(None, tick)
        return eng, seen

    thr_eng, thr_seen = _run(off_loop())
    assert len(main_seen) == len(thr_seen) > 4
    assert {s[3] for s in main_seen} == {threading.main_thread().name}
    assert threading.main_thread().name not in {s[3] for s in thr_seen}
    for (k1, a, g1, _), (k2, b, g2, _) in zip(main_seen, thr_seen):
        assert k1 == k2
        assert not g1 and not g2
        assert torch.equal(a, b)
    assert {r.uid: r.tokens for r in main_eng._done} == \
        {r.uid: r.tokens for r in thr_eng._done}
    assert torch.is_grad_enabled()


def _requires_grad(tree):
    if isinstance(tree, dict):
        return {k: _requires_grad(v) for k, v in tree.items()}
    if tree.is_floating_point():
        return tree.detach().clone().requires_grad_(True)
    return tree
