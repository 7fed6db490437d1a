"""PyTorch port vs ``jax.random``: Threefry-2x32 and the sampler's noise.

- ``fold_in``, ``random_bits`` (uint32) and ``uniform`` bitwise equal to
  ``jax.random``'s (default partitionable threefry) for seeds that
  include negative int32 values and 2**31 - 1, positions up to
  2**31 - 1, and V in {1, 97, 151936};
- ``gumbel`` within 1e-6 of ``jax.random.gumbel``, as max |Δ| over
  max |jax| (``torch.log`` against XLA's log);
- ``sampling.gumbel_noise`` draws row b from the JAX sampler's
  ``_row_key(seed[b], pos[b])``, only for the rows asked, the bits of
  each drawn row equal;
- seeded sampled requests (temperature 0.8, top-k 20) through the port's
  engine give the JAX engine's tokens, for the dense, element and block
  reduced models; no sampled step's top-2 margin of z + g is under twice
  the Gumbel error, so the equality is not luck.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as JS
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.scheduler import SchedulerConfig as JSC

from repro_torch.core import threefry as TF
from repro_torch.serving import sampling as TS
from repro_torch.serving.api import SamplingParams as TSP
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.scheduler import SchedulerConfig as TSC
from test_torch_engine import _workload, models  # noqa: F401

SEEDS = np.array([0, 1, -1, 2 ** 31 - 1, -2 ** 31, 20150406, 7], np.int32)
POS = np.array([0, 5, 2 ** 31 - 1, 77, 3, 1, 2 ** 30], np.int32)
TINY = float(np.finfo(np.float32).tiny)
GUMBEL_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _jax_keys():
    base = jax.random.PRNGKey(JS._BASE_KEY_SEED)
    keys = jax.vmap(lambda s, p: jax.random.fold_in(
        jax.random.fold_in(base, s), p))(jnp.asarray(SEEDS),
                                         jnp.asarray(POS))
    return keys, np.asarray(jax.random.key_data(keys)).astype(np.int64)


def _port_keys(device=None):
    """The row keys on the host (numpy) or, with ``device``, derived
    there as torch tensors."""
    key = TF.prng_key(JS._BASE_KEY_SEED, device)
    if device is None:
        return TF.fold_in(TF.fold_in(key, SEEDS), POS)
    return TF.fold_in(TF.fold_in(key, torch.from_numpy(SEEDS)),
                      torch.from_numpy(POS))


@pytest.mark.parametrize("seed", [0, 1, 20150406, 2 ** 31 - 1, -1, -2 ** 31])
def test_prng_key_and_fold_in_bitwise(seed):
    jk = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    tk = TF.prng_key(seed)
    assert [int(t) for t in tk] == jk.astype(np.int64).tolist()
    for data in (0, 3, 2 ** 31 - 1, -1, -2 ** 31):
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.PRNGKey(seed), np.int32(data))))
        got = TF.fold_in(tk, data)
        assert [int(t) for t in got] == want.astype(np.int64).tolist()


@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "torch"])
def test_row_keys_bitwise(device):
    _, want = _jax_keys()
    k1, k2 = _port_keys(device)
    np.testing.assert_array_equal(np.asarray(k1), want[:, 0])
    np.testing.assert_array_equal(np.asarray(k2), want[:, 1])


@pytest.mark.parametrize("v", [1, 97, 151936])
def test_bits_and_uniform_bitwise_gumbel_close(v):
    jkeys, _ = _jax_keys()
    key = _port_keys("cpu")
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(
        k, (v,), jnp.uint32))(jkeys)).astype(np.int64)
    np.testing.assert_array_equal(TF.random_bits(key, v).numpy(), bits)
    np.testing.assert_array_equal(TF.random_bits(_port_keys(), v), bits)
    uni = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (v,), jnp.float32, minval=TINY, maxval=1.0))(jkeys))
    got = TF.uniform(key, v, minval=TINY).numpy()
    np.testing.assert_array_equal(got.view(np.int32), uni.view(np.int32))
    uni0 = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (v,), jnp.float32))(jkeys))
    got0 = TF.uniform(key, v).numpy()
    np.testing.assert_array_equal(got0.view(np.int32), uni0.view(np.int32))
    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (v,), jnp.float32))(jkeys))
    tg = TF.gumbel(key, v).numpy()
    assert np.all(np.isfinite(tg))
    rel = np.abs(tg - g).max() / np.abs(g).max()
    assert rel <= GUMBEL_TOL, rel


def test_gumbel_noise_draws_only_the_sampled_rows():
    v = 1000
    rows = [1, 3, 4]
    got = TS.gumbel_noise(SEEDS.astype(np.int64) & 0xFFFFFFFF, POS, v,
                          "cpu", rows)
    jkeys, _ = _jax_keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (v,), jnp.float32))(jkeys))
    for i in range(len(SEEDS)):
        if i in rows:
            np.testing.assert_allclose(got[i].numpy(), want[i], rtol=0,
                                       atol=GUMBEL_TOL * np.abs(want).max())
        else:
            assert not got[i].any()
    full = TS.gumbel_noise(list(SEEDS), list(POS), v, "cpu")
    assert torch.equal(full[rows], got[rows])


def _sampled_run(engine_cls, req_cls, sc_cls, sp_cls, model, params, work,
                 spy=None, **kw):
    eng = engine_cls(model, params, scheduler=sc_cls(max_queue=32),
                     max_len=64, eos_id=-1, max_concurrency=4, page_size=8,
                     prefix_cache=True, prefill_chunk=8, **kw)
    if spy is not None:
        run = eng._sampler.run

        def spied(logits, sl, kind):
            spy.append((np.asarray(logits, np.float32).copy(),
                        eng._sampler.state.batch(sl, device="cpu")))
            return run(logits, sl, kind)
        eng._sampler.run = spied
    for uid, prompt, n in work:
        sp = sp_cls(temperature=0.8, top_k=20, max_tokens=n,
                    seed=2 ** 31 - 1 if uid == 9 else 7 * uid + 3)
        assert eng.submit(req_cls(uid=uid, prompt=prompt.copy(),
                                  sampling=sp))
    eng.run()
    return {r.uid: list(r.tokens) for r in eng._done}


def test_seeded_sampled_requests_give_the_reference_tokens(models):  # noqa: F811
    jm, jp, tm, tp = models
    work = _workload(jm.cfg.vocab_size)
    calls = []
    got = _sampled_run(TEngine, TRequest, TSC, TSP, tm, tp, work,
                       spy=calls, device="cpu")
    want = _sampled_run(JEngine, JRequest, JSC, JSP, jm, jp, work)
    assert got == want
    # every sampled row's decision is clear of the Gumbel error
    close = 0
    for logits, st in calls:
        t = st["temperature"].numpy()
        rows = [i for i in range(len(t)) if t[i] > 0]
        if not rows:
            continue
        z = TS.topk_mask(torch.from_numpy(logits)
                         / torch.clamp(st["temperature"], min=1e-6)[:, None],
                         st["top_k"]).numpy()
        g = TS.gumbel_noise(st["seed"].tolist(), st["pos"].tolist(),
                            logits.shape[-1], "cpu", rows).numpy()
        err = GUMBEL_TOL * np.abs(g).max()      # the Gumbel error bound
        for i in rows:
            top2 = np.sort(z[i] + g[i])[-2:]
            close += int(top2[1] - top2[0] < 2 * err)
    assert close == 0
