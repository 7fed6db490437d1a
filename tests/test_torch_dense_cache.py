"""PyTorch port vs the JAX package: the dense KV cache of the decoder.

``nn.attention.apply`` on a dense cache (``init_cache``; a scalar and a
per-row write index), ``Model.prefill`` (bucketed, with ``length``, and
exact-length) and ``Model.decode_step`` (scalar index, then per-row
indices) against the JAX package's, the models the reduced fp32 dense,
element and block configs with params carried across: outputs, logits
and the cache's K/V within 1e-5, the write index equal.  A write past the cache's end is an error (the JAX package's
``dynamic_update_slice`` would clamp it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import models  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(jcache, tcache, jlogits, tlogits):
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), rtol=0, atol=TOL)
    assert np.array_equal(np.asarray(tcache["index"]),
                          np.asarray(jcache["index"]))


@pytest.mark.parametrize("bucketed", [True, False], ids=["length", "exact"])
def test_prefill_then_decode_steps_match_reference(models, bucketed):  # noqa: F811
    jm, jp, tm, tp = models
    rng = np.random.default_rng(4)
    toks = rng.integers(2, jm.cfg.vocab_size, size=(1, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "cache": jm.init_cache(1, 48)}
    tb = {"tokens": torch.from_numpy(toks).long(),
          "cache": tm.init_cache(1, 48)}
    if bucketed:
        jb["length"] = jnp.asarray(11, jnp.int32)
        tb["length"] = 11
    jl, jc = jm.prefill(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    assert tl.shape == (1, 1, jm.cfg.padded_vocab)
    _close(jc, tc, jl, tl)
    for tok in (5, 9):
        t = np.array([[tok]], np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(t).long(), tc)
        _close(jc, tc, jl, tl)


def test_per_row_decode_positions_match_reference(models):  # noqa: F811
    """Two rows at their own positions (continuous batching on the dense
    cache): the cache index is a (B,) vector."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(6)
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2, 32)
    for b, n in enumerate((7, 12)):
        toks = rng.integers(2, jm.cfg.vocab_size, size=(1, n)).astype(
            np.int32)
        _, j1 = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                "cache": jm.init_cache(1, 32)})
        _, t1 = tm.prefill(tp, {"tokens": torch.from_numpy(toks).long(),
                                "cache": tm.init_cache(1, 32)})
        jc = {k: jc[k].at[:, b].set(j1[k][:, 0]) for k in ("k", "v")}
        for k in ("k", "v"):
            tc[k][:, b] = t1[k][:, 0]
    jc["index"] = jnp.asarray([7, 12], jnp.int32)
    tc["index"] = torch.tensor([7, 12])
    t = np.array([[3], [4]], np.int32)
    jl, jc = jm.decode_step(jp, jnp.asarray(t), jc)
    tl, tc = tm.decode_step(tp, torch.from_numpy(t).long(), tc)
    _close(jc, tc, jl, tl)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_attention_cache_write_and_mask_match_reference(per_row):
    """``nn.attention.apply`` on a dense cache from ``init_cache``, fp32,
    a chunk of 3 queries written at index 5 (per row: 5 and 9)."""
    from repro.nn import attention as JATT
    from repro_torch.nn import attention as TATT
    kw = dict(d_model=16, num_heads=4, num_kv_heads=2, head_dim=8,
              qk_norm=True)
    jplan = JATT.AttentionPlan(**kw, dtype=jnp.float32)
    tplan = TATT.AttentionPlan(**kw, dtype=torch.float32)
    jparams, _ = JATT.init(jplan, jax.random.PRNGKey(2))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jparams)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    old = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    idx = np.array([5, 9]) if per_row else 5
    pos = (idx[:, None] + np.arange(3)) if per_row else idx + np.arange(3)
    jck, jcv = JATT.init_cache(jplan, 2, 16, jnp.float32)
    tck, tcv = TATT.init_cache(tplan, 2, 16, "cpu")
    jck, jcv = jck + old, jcv - old
    tck += torch.from_numpy(old)
    tcv -= torch.from_numpy(old)
    want, (wk, wv) = JATT.apply(jplan, jparams, jnp.asarray(x),
                                positions=jnp.asarray(pos),
                                cache=(jck, jcv),
                                cache_index=jnp.asarray(idx))
    got = TATT.apply(tplan, tparams, torch.from_numpy(x),
                     positions=torch.from_numpy(np.asarray(pos)),
                     cache=(tck, tcv),
                     cache_index=torch.from_numpy(idx) if per_row else idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tck.numpy(), np.asarray(wk), rtol=0, atol=TOL)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(wv), rtol=0, atol=TOL)


def test_write_past_the_cache_end_is_an_error(models):  # noqa: F811
    _, _, tm, tp = models
    cache = tm.init_cache(1, 16)
    cache["index"] = 12
    with pytest.raises(AssertionError):
        tm.prefill(tp, {"tokens": torch.ones((1, 8), dtype=torch.long),
                        "cache": cache})
