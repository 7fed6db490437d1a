"""PyTorch port vs the JAX package: the engine's sequential scratch-cache
prefill.

- ``Engine(batched_prefill=False)`` on ``test_torch_engine.py``'s
  workload under its ``prefix-chunked-batched`` and ``preempting`` knob
  sets: greedy tokens and every deterministic counter (``COUNTERS``,
  ``fallback_chunks`` and ``prefill_batch.*`` included) equal to the JAX
  engine's, for the dense, element and block reduced models;
- within the port, the batched and the sequential path give equal
  greedy tokens;
- a chunk that fits no bucket slides its window back, as in the JAX
  engine: tokens and counters equal.
"""
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSC

from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.scheduler import SchedulerConfig as TSC
from test_torch_engine import _run, _workload, models  # noqa: F401

KNOBS = {
    "prefix-chunked-batched": dict(
        max_concurrency=4, page_size=8, prefix_cache=True, prefill_chunk=8,
        sched=dict(max_prefills_per_tick=3)),
    "preempting": dict(max_concurrency=4, page_size=4, num_pages=16,
                       prefix_cache=True, prefill_chunk=8),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("knobs", list(KNOBS))
def test_sequential_engine_matches_reference(models, knobs):  # noqa: F811
    jm, jp, tm, tp = models
    work = _workload(jm.cfg.vocab_size)
    kw = dict(max_len=64, eos_id=-1, batched_prefill=False, **KNOBS[knobs])
    jt, jcnt = _run(JEngine, JRequest, JSC, jm, jp, work, **dict(kw))
    tt, tcnt = _run(TEngine, TRequest, TSC, tm, tp, work, device="cpu",
                    **dict(kw))
    assert tt == jt
    assert tcnt == jcnt
    assert tcnt["engine.prefill_batch.dispatches"] == 0
    assert tcnt["prefix.hit_tokens"] > 0
    if knobs == "preempting":
        assert tcnt["engine.preemptions"] > 0


def test_batched_and_sequential_give_equal_tokens(models):  # noqa: F811
    _, _, tm, tp = models
    work = _workload(tm.cfg.vocab_size)
    kw = dict(device="cpu", max_len=64, eos_id=-1, **KNOBS["preempting"])
    bat, bcnt = _run(TEngine, TRequest, TSC, tm, tp, work, **dict(kw))
    seq, scnt = _run(TEngine, TRequest, TSC, tm, tp, work,
                     batched_prefill=False, **dict(kw))
    assert seq == bat
    assert bcnt["engine.prefill_batch.dispatches"] > 0
    assert scnt["engine.prefill_batch.dispatches"] == 0


def test_slide_back_window_matches_reference(models):  # noqa: F811
    """Chunks of 10 over a 29-token prompt at max_len 32: the third chunk
    (9 tokens at position 20, 12 slots of room) fits no bucket, so the
    window slides back to start at 13 and recomputes 7 positions."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(11)
    work = [(u, rng.integers(2, jm.cfg.vocab_size, size=n).astype(np.int32),
             3) for u, n in enumerate((29, 21))]
    kw = dict(max_len=32, eos_id=-1, batched_prefill=False,
              max_concurrency=2, page_size=8, prefill_chunk=10)
    jt, jcnt = _run(JEngine, JRequest, JSC, jm, jp, work, **dict(kw))
    tt, tcnt = _run(TEngine, TRequest, TSC, tm, tp, work, device="cpu",
                    **dict(kw))
    assert tt == jt and tcnt == jcnt
    eng = TEngine(tm, tp, device="cpu", **{k: v for k, v in kw.items()
                                            if k != "batched_prefill"})
    assert eng._chunk_shape(20, 9) == (13, 16, 16)
