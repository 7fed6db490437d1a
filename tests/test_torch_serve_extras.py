"""PyTorch port vs the JAX package: ``extras`` rows, ``generate_batch``
and the graceful-drain entry of the engine.

- two requests with ``extras`` (``{"frames": ...}`` on the decoder)
  under ``batched_prefill=True`` fall back to the sequential path as in
  the JAX engine: tokens and every counter of ``COUNTERS``
  (``fallback_chunks`` included) equal, for the dense, element and block
  reduced models;
- ``generate_batch`` returns an engine's tokens in prompt order;
- ``cancel_queued`` marks every queued request cancelled and leaves the
  in-flight rows to finish.
"""
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSC

from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import generate_batch as tgenerate
from repro_torch.serving.scheduler import SchedulerConfig as TSC
from test_torch_engine import COUNTERS, _workload, models  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _extras_run(engine_cls, req_cls, sc_cls, model, params, work, **kw):
    eng = engine_cls(model, params, scheduler=sc_cls(max_queue=32),
                     max_len=64, eos_id=-1, max_concurrency=4, page_size=8,
                     prefix_cache=True, prefill_chunk=8, **kw)
    rng = np.random.default_rng(3)
    for uid, prompt, n in work[:6]:
        extras = None
        if uid in (1, 4):
            extras = {"frames": rng.standard_normal(
                (1, 4, model.cfg.d_model)).astype(np.float32)}
        assert eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                                  max_new_tokens=n, extras=extras))
    eng.run()
    eng.kv.leak_check()
    snap = eng.metrics.snapshot()
    return {r.uid: list(r.tokens) for r in eng._done}, \
        {k: snap.get(k) for k in COUNTERS}


def test_extras_rows_fall_back_to_the_sequential_path(models):  # noqa: F811
    jm, jp, tm, tp = models
    work = _workload(jm.cfg.vocab_size)
    jt, jcnt = _extras_run(JEngine, JRequest, JSC, jm, jp, work)
    tt, tcnt = _extras_run(TEngine, TRequest, TSC, tm, tp, work,
                           device="cpu")
    assert tt == jt
    assert tcnt == jcnt
    assert tcnt["engine.prefill_batch.fallback_chunks"] == 2
    assert tcnt["engine.prefill_batch.dispatches"] > 0


def test_cancel_queued_leaves_in_flight_rows_to_finish(models):  # noqa: F811
    _, _, tm, tp = models
    eng = TEngine(tm, tp, device="cpu", max_concurrency=2, max_len=48,
                  eos_id=-1, page_size=8, batched_prefill=False,
                  scheduler=TSC(max_queue=8, max_prefills_per_tick=2))
    rng = np.random.default_rng(5)
    handles = [eng.submit(TRequest(uid=u, prompt=rng.integers(
        2, tm.cfg.vocab_size, size=9).astype(np.int32), max_new_tokens=4))
        for u in range(5)]
    eng.step()                            # rows 0 and 1 admitted
    cancelled = eng.cancel_queued()
    assert sorted(r.uid for r in cancelled) == [2, 3, 4]
    eng.run()
    assert sorted(r.uid for r in eng._done) == [0, 1]
    assert all(len(r.tokens) == 4 for r in eng._done)
    for h in handles[2:]:
        deltas = h.drain()
        assert deltas and deltas[-1].done
        assert deltas[-1].finish_reason == "cancelled"
    snap = eng.metrics.snapshot()
    assert snap["engine.cancelled"] == 3 and snap["engine.failed"] == 3
    assert not eng.pending()


def test_generate_batch_is_the_engine_run_to_completion(models):  # noqa: F811
    """``generate_batch`` (sequential prefill, one request with extras)
    returns, in prompt order, the tokens of an engine given the same
    requests; the sequential engine itself is held to the JAX engine in
    ``test_torch_serve_seq.py``."""
    _, _, tm, tp = models
    rng = np.random.default_rng(8)
    prompts = [rng.integers(2, tm.cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 19, 33, 2, 12)]
    extras = [None, {"frames": np.zeros((1, 4, 8), np.float32)}, None,
              None, None]
    kw = dict(max_len=64, eos_id=-1, page_size=8, prefill_chunk=16,
              batched_prefill=False, device="cpu")
    got = tgenerate(tm, tp, prompts, max_new_tokens=5, slots=2,
                    extras=extras, **kw)
    eng = TEngine(tm, tp, max_concurrency=2, scheduler=TSC(max_queue=8),
                  **kw)
    for uid in (3, 0, 4, 1, 2):          # submission order is not output order
        assert eng.submit(TRequest(uid=uid, prompt=prompts[uid],
                                   max_new_tokens=5, extras=extras[uid]))
    eng.run()
    want = {r.uid: r.tokens for r in eng._done}
    assert got == [want[u] for u in range(5)]
    assert [len(t) for t in got] == [5] * 5
