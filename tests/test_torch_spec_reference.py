"""The port's speculative engine against the JAX package's spec engine on
the same params.

- The equal 1/8 rung at a fixed k=3 on one-token prompts (greedy, seeded
  with top-k and top-p, one with a repetition penalty): tokens equal,
  and every ``spec`` counter equal (ticks, proposals, accepted drafts,
  rollbacks, dispatches, baseline rows).  One-token prompts keep the
  draft's history within the propose step: the JAX engine's separate
  catch-up dispatch (``repro/serving/spec_decode.py``, ``_catchup``)
  leaves its draft off the served history (an equal-rung draft there
  misses most proposals that the port's accepts), which moves its
  counters though never its tokens (ROADMAP Queue C).
- The projected 1/16 rung at adaptive k under a tight pool, the prefix
  cache and chunked prefill (``test_torch_spec_adaptive.py``, a file of
  its own to keep each file's time short): tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import draft as jdraft
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest

from repro_torch.interop import params_to_numpy
from repro_torch.serving import draft as tdraft
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request
from test_torch_spec_decode import models, run  # noqa: F401  (fixture)

SPEC_KEYS = ("ticks", "proposed", "accepted_drafts", "draft_dispatches",
             "verify_dispatches", "baseline_rows")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def sampled(uid: int, max_tokens: int = 9) -> dict:
    """Every request but the first seeded (top-k, top-p; uid 2 also a
    repetition penalty), so each tick's batch keeps one sampler
    specialization and the JAX engine compiles each dispatch once."""
    if uid == 0:
        return dict(max_tokens=max_tokens - 4)
    sp = dict(temperature=0.8, top_k=20, top_p=0.95, seed=uid,
              max_tokens=max_tokens)
    if uid == 2:
        sp["repetition_penalty"] = 1.2
    return sp


def compare(models, ratio: str, adaptive: bool, requests, knobs):
    """Serve ``requests`` through both spec engines with the ``ratio``
    draft; returns (port engine, JAX engine) after asserting equal
    tokens.  The JAX draft model runs on the port's draft params (a
    projected rung's banks are threaded scatter-add sums whose last bits
    vary between the JAX package's runs; test_torch_spec_decode.py
    compares them)."""
    jc, jm, jp, tc, tm, tp = models
    _, tdm, tdp = tdraft.build_draft(tc, tp, ratio)
    _, jdm, _ = jdraft.build_draft(jc, jp, 1.0 / int(ratio.split("/")[1]))
    jdp = jax.tree.map(jnp.asarray, params_to_numpy(tdp))
    jeng = JEngine(jm, jp, draft=(jdm, jdp), spec_k=3,
                   spec_adaptive=adaptive, **knobs)
    want = run(jeng, JRequest, JSP, requests)
    eng = Engine(tm, tp, device="cpu", draft=(tdm, tdp), spec_k=3,
                 spec_adaptive=adaptive, **knobs)
    assert run(eng, Request, SamplingParams, requests) == want
    return eng, jeng


def test_spec_engine_tokens_and_counters_match_reference(models):  # noqa: F811
    rng = np.random.default_rng(4)
    requests = [(uid, rng.integers(2, 512, 1).astype(np.int32), sampled(uid))
                for uid in range(5)]
    eng, jeng = compare(models, "1/8", False, requests,
                        dict(max_len=64, eos_id=-1, max_concurrency=3,
                             page_size=8))
    st, jst = eng.stats()["spec"], jeng.stats()["spec"]
    assert {k: st[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert st["accepted_drafts"] > st["proposed"] // 2
    assert eng.metrics.snapshot()["spec.rollback_tokens"] == \
        jeng.metrics.snapshot()["spec.rollback_tokens"]
