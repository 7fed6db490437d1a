"""PyTorch port vs the JAX package: hashing, hashed specs, policy specs.

Hash indices, signs and materialized virtual matrices must be BITWISE
equal to the JAX package's (the port masks int64 where JAX wraps
uint32), and the port's ``bank_spec_map`` must resolve to the same
``HashedSpec.to_dict()`` as the JAX package's, at full width and for
the reduced variants.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashed as JH
from repro.core import hashing as JHS
import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.models.transformer import bank_spec_map as jbank_spec_map

import repro_torch.configs as TC
from repro_torch.core import hashed as TH
from repro_torch.core import hashing as THS
from repro_torch.models.transformer import bank_spec_map as tbank_spec_map


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Cap torch's intra-op pool: several pytest workers share the cores
    with the JAX suite's timing-sensitive tests."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _grid():
    # large i and j: near 2**31 and past 2**16, where uint32 products wrap
    i = np.concatenate([np.arange(0, 40), np.arange(2 ** 31 - 40, 2 ** 31),
                        np.arange(70000, 70040)]).astype(np.int64)[:, None]
    j = np.concatenate([np.arange(0, 50), np.arange(2 ** 20, 2 ** 20 + 50)]
                       ).astype(np.int64)[None, :]
    return i, j


@pytest.mark.parametrize("num_buckets", [393216, 131072, 1000, 7])
@pytest.mark.parametrize("seed", [0, 0xDEADBEEF, 12345])
def test_bucket_and_sign_hash_bitwise(num_buckets, seed):
    i, j = _grid()
    ji, jj = jnp.asarray(i, jnp.uint32), jnp.asarray(j, jnp.uint32)
    want_h = np.asarray(JHS.bucket_hash(ji, jj, num_buckets, seed))
    want_s = np.asarray(JHS.sign_hash(ji, jj, seed))
    ti, tj = torch.from_numpy(i), torch.from_numpy(j)
    np.testing.assert_array_equal(
        THS.bucket_hash(ti, tj, num_buckets, seed).numpy(), want_h)
    np.testing.assert_array_equal(THS.sign_hash(ti, tj, seed).numpy(),
                                  want_s)
    assert THS.derive_seed(seed, 3, 2 ** 31 + 5) == \
        JHS.derive_seed(seed, 3, 2 ** 31 + 5)


@pytest.mark.parametrize("panel_cols", [0, 16, 48])
def test_element_indices_and_materialize_bitwise(panel_cols):
    spec_kw = dict(virtual_shape=(96, 112), compression=0.125,
                   mode="element", seed=0xC0FFEE, panel_cols=panel_cols)
    js, ts = JH.HashedSpec(**spec_kw), TH.HashedSpec(**spec_kw)
    assert ts.num_buckets == js.num_buckets
    i, j = _grid()
    jidx, jsgn = JH.element_indices(js, jnp.asarray(i, jnp.int32),
                                    jnp.asarray(j, jnp.int32))
    tidx, tsgn = TH.element_indices(ts, torch.from_numpy(i),
                                    torch.from_numpy(j))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tsgn.numpy(), np.asarray(jsgn))
    w = np.random.default_rng(0).standard_normal(
        js.num_buckets).astype(np.float32)
    np.testing.assert_array_equal(
        TH.materialize(torch.from_numpy(w), ts).numpy(),
        np.asarray(JH.materialize(jnp.asarray(w), js)))
    rows = np.array([[0, 95, 17], [3, 3, 60]])
    np.testing.assert_array_equal(
        TH.materialize_rows(torch.from_numpy(w), ts,
                            torch.from_numpy(rows)).numpy(),
        np.asarray(JH.materialize_rows(jnp.asarray(w), js,
                                       jnp.asarray(rows))))


@pytest.mark.parametrize("shape,block", [((96, 112), (32, 16)),
                                         ((100, 70), (32, 16)),
                                         ((33, 65), (16, 32))])
def test_block_indices_and_materialize_bitwise_ragged(shape, block):
    kw = dict(virtual_shape=shape, compression=0.25, mode="block", seed=7,
              block_shape=block)
    js, ts = JH.HashedSpec(**kw), TH.HashedSpec(**kw)
    jidx, jsgn = JH.block_indices(js)
    tidx, tsgn = TH.block_indices(ts)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tsgn.numpy(), np.asarray(jsgn))
    w = np.random.default_rng(1).standard_normal(
        js.real_param_shape()).astype(np.float32)
    np.testing.assert_array_equal(
        TH.materialize(torch.from_numpy(w), ts).numpy(),
        np.asarray(JH.materialize(jnp.asarray(w), js)))
    rows = np.array([0, shape[0] - 1, shape[0] // 2])
    np.testing.assert_array_equal(
        TH.materialize_rows(torch.from_numpy(w), ts,
                            torch.from_numpy(rows)).numpy(),
        np.asarray(JH.materialize_rows(jnp.asarray(w), js,
                                       jnp.asarray(rows))))


@pytest.mark.parametrize("path", ["materialize", "scan", "pallas"])
def test_matmul_paths_match_reference(path):
    """Every port execution path against the JAX materialize oracle
    (fp32; the paths sum in another order, so atol 1e-5)."""
    kw = dict(virtual_shape=(64, 96), compression=0.125, seed=3,
              panel_cols=32)
    js, ts = JH.HashedSpec(**kw), TH.HashedSpec(**kw)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(js.num_buckets).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = np.asarray(JH.matmul(jnp.asarray(x), jnp.asarray(w), js,
                                path="materialize"))
    got = TH.matmul(torch.from_numpy(x), torch.from_numpy(w), ts, path=path)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_spec_dict_roundtrip_identical():
    kw = dict(virtual_shape=(2048, 6144), compression=0.125, seed=99,
              panel_cols=512)
    d = TH.HashedSpec(**kw).to_dict()
    assert d == JH.HashedSpec(**kw).to_dict()
    assert TH.spec_from_dict(d) == TH.HashedSpec(**kw)


@pytest.mark.parametrize("name", ["qwen3-1.7b-hashed8",
                                  "qwen3-1.7b-reduced-hashed8",
                                  "qwen3-1.7b-hashedc0.3"])
def test_bank_spec_map_matches_reference(name):
    """Spec arithmetic only (no arrays): full width and reduced."""
    jmap = jbank_spec_map(JC.get(name))
    tmap = tbank_spec_map(TC.get(name))
    assert set(jmap) == set(tmap)
    for path in jmap:
        assert tmap[path].to_dict() == jmap[path].to_dict(), path
        assert tmap[path].num_buckets == jmap[path].num_buckets


def test_bank_spec_map_serving_bench_variant_and_policy():
    """The serving bench's reduced fp32 hashed config, and a budget
    policy variant resolved by the port's own policy solver."""
    jb = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32")
    tb = TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32")
    from repro import policy as JP
    from repro_torch import policy as TP
    cases = [(jb.hashed_variant(0.125), tb.hashed_variant(0.125)),
             (jb.policy_variant(JP.CompressionPolicy(budget=0.1, rules=(
                 JP.PolicyRule(match="layers.attn.*", compression=0.25),))),
              tb.policy_variant(TP.CompressionPolicy(budget=0.1, rules=(
                  TP.PolicyRule(match="layers.attn.*", compression=0.25),))))]
    for jcfg, tcfg in cases:
        jmap, tmap = jbank_spec_map(jcfg), tbank_spec_map(tcfg)
        assert {p: s.to_dict() for p, s in tmap.items()} == \
            {p: s.to_dict() for p, s in jmap.items()}
    # reference policy JSON (exec path "pallas") resolves in the port
    assert TP.policy_from_dict(JP.policy_to_dict(JP.CompressionPolicy(
        path="pallas"))).path == "pallas"
