"""PyTorch port vs the JAX package: the four serving kernels.

On the CPU each port wrapper runs its plain PyTorch version; these tests
hold it against the JAX package's ``kernels/ref.py`` oracle and the
Pallas kernel in interpret mode, at tiny shapes.  fp32 tolerances are
atol 1e-5 (the two sides sum in another order); the top-k mask must be
bitwise equal.  The CUDA kernels themselves are held against their
plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashed as JH
from repro.kernels import flash_prefill as JFP
from repro.kernels import hashed_matmul as JHK
from repro.kernels import ops as JOPS
from repro.kernels import paged_attention as JPA
from repro.kernels import ref as JREF
from repro.kernels import topk as JTK

from repro_torch.core import hashed as TH
from repro_torch.kernels import flash_prefill as TFP
from repro_torch.kernels import hashed_matmul as THK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import topk as TTK
from repro_torch.serving import sampling as TS

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# hashed GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [3, 8, 13])
@pytest.mark.parametrize("panel_cols", [0, 16])
def test_hashed_matmul_plain_vs_reference_and_pallas(m, panel_cols):
    """M not a multiple of the block, panelled and global bucket spaces."""
    kw = dict(virtual_shape=(32, 32), compression=0.25, seed=11,
              panel_cols=panel_cols)
    js, ts = JH.HashedSpec(**kw), TH.HashedSpec(**kw)
    rng = np.random.default_rng(m)
    w = rng.standard_normal(js.num_buckets).astype(np.float32)
    x = rng.standard_normal((m, 32)).astype(np.float32)
    got = TOPS.hashed_matmul(_t(x), _t(w), ts).numpy()
    want_ref = np.asarray(JREF.hashed_matmul_ref(jnp.asarray(x),
                                                 jnp.asarray(w), js))
    want_pl = np.asarray(JOPS.hashed_matmul(jnp.asarray(x), jnp.asarray(w),
                                            js, interpret=True,
                                            block=(8, 16, 16)))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=ATOL)


def test_element_matmul_plain_vs_pallas_kernel():
    kw = dict(virtual_shape=(32, 48), compression=0.125, seed=5,
              panel_cols=16)
    js, ts = JH.HashedSpec(**kw), TH.HashedSpec(**kw)
    rng = np.random.default_rng(0)
    w = rng.standard_normal(js.num_buckets).astype(np.float32)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    want = np.asarray(JHK.element_matmul(jnp.asarray(x), jnp.asarray(w), js,
                                         block=(8, 16, 16), interpret=True))
    got = THK.element_matmul(_t(x), _t(w), ts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_pick_bm_and_pad_rows_match_reference():
    for m in (1, 5, 8, 9, 100, 128, 200, 256):
        assert TOPS._pick_bm(m) == JOPS._pick_bm(m)
    x, m = TOPS._pad_rows(torch.ones(5, 3), 8)
    assert m == 5 and x.shape == (8, 3) and float(x[5:].abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _pool(rng, npages, ps, nkv, d):
    pk = rng.standard_normal((npages, ps, nkv, d)).astype(np.float32)
    pv = rng.standard_normal((npages, ps, nkv, d)).astype(np.float32)
    return pk, pv


@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_plain_vs_reference_and_pallas(window):
    """Ragged lengths, a length-0 row on the trash page, window > 0."""
    rng = np.random.default_rng(window)
    b, hq, nkv, d, ps, maxp = 4, 4, 2, 16, 4, 4
    pk, pv = _pool(rng, 12, ps, nkv, d)
    table = np.array([[1, 2, 3, 0], [0, 0, 0, 0], [4, 5, 6, 7],
                      [8, 9, 0, 0]], np.int32)
    lengths = np.array([9, 0, 16, 5], np.int32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    got = TPA.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(table),
                                     _t(lengths), window).numpy()
    args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(table), jnp.asarray(lengths))
    want_ref = np.asarray(JREF.paged_attention_ref(*args, window))
    want_pl = np.asarray(JPA.paged_decode_attention(*args, jnp.int32(window),
                                                    interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0)          # length-0 row gives zeros


# ---------------------------------------------------------------------------
# ragged prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 6])
def test_paged_prefill_plain_vs_reference_and_pallas(window):
    """starts > 0 over shared prefix pages, a count-0 row, pad slots."""
    rng = np.random.default_rng(10 + window)
    b, s, hq, nkv, d, ps = 3, 8, 4, 2, 16, 4
    pk, pv = _pool(rng, 12, ps, nkv, d)
    # rows 0 and 2 share prefix page 1; row 1 is an inert count-0 row
    table = np.array([[1, 2, 3, 4], [0, 0, 0, 0], [1, 5, 6, 7]], np.int32)
    starts = np.array([4, 0, 6], np.int32)
    counts = np.array([8, 0, 5], np.int32)
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    got = TFP.paged_prefill_attention(_t(q), _t(pk), _t(pv), _t(table),
                                      _t(starts), _t(counts), window).numpy()
    args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(table), jnp.asarray(starts), jnp.asarray(counts))
    want_ref = np.asarray(JREF.paged_prefill_ref(*args, window))
    want_pl = np.asarray(JFP.paged_prefill_attention(*args, jnp.int32(window),
                                                     interpret=True))
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=ATOL)
    assert np.all(got[1] == 0.0) and np.all(got[2, 5:] == 0.0)


# ---------------------------------------------------------------------------
# top-k mask and the sampler's filters
# ---------------------------------------------------------------------------

def _topk_case():
    rng = np.random.default_rng(3)
    v = 200
    x = rng.standard_normal((6, v)).astype(np.float32)
    x[2, :30] = 1.25                  # ties straddling the threshold
    x[3] = 0.0
    x[3, 1::2] = -0.0                 # +-0.0 at the threshold
    x[3, :5] = 2.0
    k = np.array([0, -3, 10, 20, v, 1], np.int32)   # k<=0, k>=V disable
    return x, k


def test_topk_mask_plain_vs_reference_and_pallas_bitwise():
    x, k = _topk_case()
    got = TTK.topk_mask(_t(x), _t(k)).numpy()
    want_ref = np.asarray(JREF.topk_mask_ref(jnp.asarray(x), jnp.asarray(k)))
    want_pl = np.asarray(JTK.topk_mask(jnp.asarray(x), jnp.asarray(k),
                                       use_pallas=True, interpret=True))
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_pl)
    assert np.all(got[3] != TTK.NEG)  # every +-0.0 tie survives


def test_sampler_filters_vs_reference_walks():
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((5, 64)) * 3).astype(np.float32)
    p = np.array([0.5, 0.9, 1.0, 0.05, 0.999], np.float32)
    mp = np.array([0.0, 0.1, 0.5, 0.9, 0.01], np.float32)
    got_p = TS.topp_mask(_t(z), _t(p)).numpy()
    got_m = TS.minp_mask(_t(z), _t(mp)).numpy()
    np.testing.assert_array_equal(
        got_p, np.asarray(JREF.topp_mask_ref(jnp.asarray(z), p)))
    np.testing.assert_array_equal(got_p, TTK.topp_mask_ref(_t(z), _t(p))
                                  .numpy())
    np.testing.assert_array_equal(
        got_m, np.asarray(JREF.minp_mask_ref(jnp.asarray(z), mp)))
    np.testing.assert_array_equal(got_m, TTK.minp_mask_ref(_t(z), _t(mp))
                                  .numpy())


def test_wrappers_refuse_non_cuda_non_cpu_tensors():
    x = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError):
        TTK.topk_mask(x, torch.zeros(2, dtype=torch.int32))
