"""The port's adaptive-k speculative engine with the projected 1/16 draft
against the JAX package's, under a tight pool (preemption), the prefix
cache and chunked prefill, greedy and seeded requests: tokens equal,
rollbacks taken, and k moved off its maximum.  The counters are not
compared (see ``test_torch_spec_reference.py``): the JAX engine's draft
catch-up misses, and a projected rung's near-random proposals meet
near-ties that its threaded CPU reductions break differently from run to
run; no emitted token depends on either.
"""
import numpy as np
import pytest
import torch

from test_torch_spec_decode import models  # noqa: F401  (fixture)
from test_torch_spec_reference import compare, sampled


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_adaptive_spec_engine_tokens_match_reference(models):  # noqa: F811
    rng = np.random.default_rng(2)
    shared = rng.integers(2, 512, 10).astype(np.int32)
    requests = []
    for uid in range(5):
        p = rng.integers(2, 512, int(rng.integers(3, 12))).astype(np.int32)
        requests.append((uid, np.concatenate([shared, p]) if uid % 2 else p,
                         sampled(uid)))
    eng, jeng = compare(models, "1/16", True, requests,
                        dict(max_len=64, eos_id=-1, max_concurrency=3,
                             page_size=4, num_pages=11, prefix_cache=True,
                             prefill_chunk=8))
    st = eng.stats()
    assert st["spec"]["adaptive"] and st["spec"]["k"] < st["spec"]["k_max"]
    assert st["preemptions"] > 0 and st["hit_tokens"] > 0
    assert eng.metrics.snapshot()["spec.rollback_tokens"] > 0
    assert jeng.stats()["spec"]["adaptive"]
