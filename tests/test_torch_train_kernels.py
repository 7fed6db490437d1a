"""PyTorch port vs the JAX package: the hashed GEMM's backward kernels and
block mode.

On the CPU each port wrapper runs its plain PyTorch version; these tests
hold it against the JAX package's Pallas kernels in interpret mode and
against its ``kernels/ref.py`` oracles, at small shapes:

- element ``dx`` (``element_matmul(transpose=True)``) and ``dw``
  (``element_dw``), with a global bucket space and with 128-column panels;
- block forward, transpose and ``dw`` (``block_matmul``, ``block_dw``);
- the autograd Function's gradients against ``jax.grad`` of the JAX
  package's ``ops.hashed_matmul`` in both modes, with M not a multiple
  of the row block and with leading batch dims;
- the ragged block grid refused with ``ValueError``.

Tolerance: fp32 max error <= 1e-5 x max(1, largest reference value); the
two sides sum in another order.  The CUDA kernels themselves are held
against these plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashed as JH
from repro.kernels import hashed_matmul as JHK
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF

from repro_torch import kernels as K
from repro_torch.core import hashed as TH
from repro_torch.kernels import hashed_matmul as THK
from repro_torch.kernels import ops as TOPS

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _specs(**kw):
    return JH.HashedSpec(**kw), TH.HashedSpec(**kw)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("panel_cols", [0, 128])
def test_element_dx_plain_vs_pallas_transpose_and_oracle(panel_cols):
    js, ts = _specs(virtual_shape=(64, 256), compression=0.125, seed=11,
                    panel_cols=panel_cols)
    rng = np.random.default_rng(panel_cols)
    w = _rand(rng, js.num_buckets)
    g = _rand(rng, 16, 256)
    got = THK.element_matmul_t(_t(g), _t(w), ts).numpy()
    want_pl = JHK.element_matmul(jnp.asarray(g), jnp.asarray(w), js,
                                 block=(8, 64, 32), transpose=True,
                                 interpret=True)
    want_ref = JREF.hashed_matmul_t_ref(jnp.asarray(g), jnp.asarray(w), js)
    _close(got, want_pl)
    _close(got, want_ref)


@pytest.mark.parametrize("panel_cols", [0, 128])
def test_element_dw_plain_vs_pallas_and_oracle(panel_cols):
    js, ts = _specs(virtual_shape=(64, 256), compression=0.125, seed=23,
                    panel_cols=panel_cols)
    rng = np.random.default_rng(100 + panel_cols)
    x = _rand(rng, 16, 64)
    g = _rand(rng, 16, 256)
    got = THK.element_dw(_t(x), _t(g), ts).numpy()
    assert got.dtype == np.float32 and got.shape == (js.num_buckets,)
    want_pl = JHK.element_dw(jnp.asarray(x), jnp.asarray(g), js,
                             block=(8, 32, 64), interpret=True)
    want_ref = JREF.hashed_dw_ref(jnp.asarray(x), jnp.asarray(g), js)
    _close(got, want_pl)
    _close(got, want_ref)


@pytest.mark.parametrize("panel_cols", [0, 128])
@pytest.mark.parametrize("use_sign", [True, False])
def test_element_dw_map_and_segment_sums_vs_pallas(panel_cols, use_sign):
    """``element_dw``'s inverse map (``element_segments``): every virtual
    position once, grouped by the JAX package's bucket, ascending inside a
    bucket, bit 31 set exactly where the JAX sign is -1.  Summing
    xi * (x^T g) over it in map order, as the kernel's segment pass does,
    gives the Pallas kernel's dw."""
    js, ts = _specs(virtual_shape=(64, 256), compression=0.125, seed=23,
                    panel_cols=panel_cols, use_sign=use_sign)
    order, offsets = THK.element_segments(ts, "cpu")
    assert order.dtype == offsets.dtype == torch.int32
    o = order.numpy().astype(np.int64)
    pos, neg = o & 0x7FFFFFFF, o < 0
    jidx, jsgn = JH.element_indices(js, jnp.arange(64)[:, None],
                                    jnp.arange(256)[None, :])
    jidx = np.asarray(jidx).reshape(-1)
    jsgn = np.asarray(jsgn).reshape(-1)
    assert np.array_equal(np.sort(pos), np.arange(64 * 256))
    offs = offsets.numpy()
    assert offs[0] == 0 and offs[-1] == 64 * 256
    bucket = np.repeat(np.arange(js.num_buckets), np.diff(offs))
    assert np.array_equal(jidx[pos], bucket)
    same = bucket[1:] == bucket[:-1]
    assert np.all(pos[1:][same] > pos[:-1][same])
    assert np.array_equal(neg, jsgn[pos] < 0)
    assert neg.any() == use_sign
    rng = np.random.default_rng(7 + panel_cols)
    x = _rand(rng, 16, 64)
    g = _rand(rng, 16, 256)
    prod = (x.astype(np.float64).T @ g).reshape(-1)
    dw = np.zeros(js.num_buckets)
    np.add.at(dw, bucket, np.where(neg, -prod[pos], prod[pos]))
    want_pl = JHK.element_dw(jnp.asarray(x), jnp.asarray(g), js,
                             block=(8, 32, 64), interpret=True)
    _close(dw, want_pl)


@pytest.mark.parametrize("block_shape", [(32, 64), (64, 32)])
def test_block_fwd_transpose_dw_plain_vs_pallas_and_oracle(block_shape):
    js, ts = _specs(virtual_shape=(128, 192), compression=0.25, seed=7,
                    mode="block", block_shape=block_shape)
    rng = np.random.default_rng(block_shape[0])
    w = _rand(rng, *js.real_param_shape())
    x = _rand(rng, 16, 128)
    g = _rand(rng, 16, 192)
    jw, jx, jg = jnp.asarray(w), jnp.asarray(x), jnp.asarray(g)
    # forward
    got = THK.block_matmul(_t(x), _t(w), ts).numpy()
    _close(got, JHK.block_matmul(jx, jw, js, bm=8, interpret=True))
    _close(got, JREF.hashed_matmul_ref(jx, jw, js))
    # transpose
    got = THK.block_matmul(_t(g), _t(w), ts, transpose=True).numpy()
    _close(got, JHK.block_matmul(jg, jw, js, bm=8, transpose=True,
                                 interpret=True))
    _close(got, JREF.hashed_matmul_t_ref(jg, jw, js))
    # dbank, including bank tiles no virtual tile maps to (zeros)
    got = THK.block_dw(_t(x), _t(g), ts).numpy()
    assert got.shape == js.real_param_shape()
    _close(got, JHK.block_dw(jx, jg, js, bm=8, interpret=True))
    _close(got, JREF.hashed_dw_ref(jx, jg, js))


def test_block_dw_plain_pads_ragged_grid_like_oracle():
    js, ts = _specs(virtual_shape=(80, 72), compression=0.5, seed=3,
                    mode="block", block_shape=(32, 32))
    rng = np.random.default_rng(5)
    x, g = _rand(rng, 9, 80), _rand(rng, 9, 72)
    got = THK.hashed_dw_ref(_t(x), _t(g), ts).numpy()
    _close(got, JREF.hashed_dw_ref(jnp.asarray(x), jnp.asarray(g), js))


def _grad_case(mode):
    if mode == "element":
        kw = dict(virtual_shape=(64, 128), compression=0.125, seed=3,
                  panel_cols=64)
        block = (8, 32, 32)
    else:
        kw = dict(virtual_shape=(64, 128), compression=0.25, seed=17,
                  mode="block", block_shape=(32, 32))
        block = (8, 32, 32)
    return _specs(**kw), block


@pytest.mark.parametrize("lead", [(13,), (3, 7)], ids=["m13", "b3xs7"])
@pytest.mark.parametrize("mode", ["element", "block"])
def test_autograd_function_grads_match_jax_custom_vjp(mode, lead):
    """Rows not a multiple of the row block (13 and 21 with bm 8 -> 16,
    24 after padding) and leading batch dims."""
    (js, ts), block = _grad_case(mode)
    rng = np.random.default_rng(len(lead))
    w = _rand(rng, *js.real_param_shape())
    x = _rand(rng, *lead, 64)
    cot = _rand(rng, *lead, 128)

    def jloss(x_, w_):
        y = JOPS.hashed_matmul(x_, w_, js, interpret=True, block=block)
        return (y * cot).sum()

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx = _t(x).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    y = TOPS.hashed_matmul(tx, tw, ts, block=block)
    assert y.shape == (*lead, 128)
    (y * _t(cot)).sum().backward()
    _close(tx.grad.numpy(), jdx)
    _close(tw.grad.numpy(), jdw)
    assert tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype


def test_ragged_block_grid_raises_like_reference():
    js, ts = _specs(virtual_shape=(80, 64), compression=0.25, mode="block",
                    block_shape=(32, 32))
    x = np.zeros((4, 80), np.float32)
    w = np.zeros(js.real_param_shape(), np.float32)
    with pytest.raises(ValueError, match="divide virtual_shape"):
        JOPS.hashed_matmul(jnp.asarray(x), jnp.asarray(w), js)
    with pytest.raises(ValueError, match="divide virtual_shape"):
        TOPS.hashed_matmul(_t(x), _t(w), ts)


def test_cpu_backward_launches_no_kernel():
    (js, ts), block = _grad_case("element")
    before = K.counts()
    w = torch.zeros(ts.real_param_shape(), requires_grad=True)
    x = torch.ones(5, 64, requires_grad=True)
    TOPS.hashed_matmul(x, w, ts, block=block).sum().backward()
    assert K.counts() == before
    assert set(before) == {"hashed_matmul", "hashed_matmul_t", "hashed_dw",
                           "block_matmul", "block_dw", "paged_decode",
                           "paged_prefill", "topk_mask"}
