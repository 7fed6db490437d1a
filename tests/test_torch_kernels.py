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


@pytest.mark.parametrize("max_pages,page_size,want", [
    (16, 16, 4), (32, 8, 4), (1, 16, 1), (5, 16, 2), (4, 4, 1), (17, 16, 5),
    (0, 16, 1)])
def test_decode_chunks(max_pages, page_size, want):
    """The split-KV decode's grid: ceil(table positions / 64) chunks a
    row, at least one."""
    assert TPA.DECODE_CHUNK == 64
    assert TPA.decode_chunks(max_pages, page_size) == want


# rows of the split-KV cases: empty, one position, the 64-position chunk
# edges, and the whole table (160 positions: 20 pages of 8, 10 of 16)
_SPLIT_LENGTHS = [0, 1, 63, 64, 65, 129, 160]


def _live_chunks(length, window, max_pages, page_size):
    """The chunks whose blocks the split-KV decode keeps (csrc
    ``live_range``; the others exit at once and the merge skips them):
    those meeting [max(0, length - window) (window > 0, else 0),
    min(length, max_pages * page_size))."""
    hi = min(length, max_pages * page_size)
    lo = max(0, length - window) if window > 0 else 0
    if hi <= lo:
        return range(0)
    return range(lo // TPA.DECODE_CHUNK, -(-hi // TPA.DECODE_CHUNK))


def _split_case(rng, page_size, d, hq=4, nkv=2):
    """A table of private pages in random order per row (trash page 0
    past each row's length) over a pool of random K/V."""
    b, maxp = len(_SPLIT_LENGTHS), 160 // page_size
    npages = b * maxp + 1
    pk, pv = _pool(rng, npages, page_size, nkv, d)
    table = (rng.permutation(npages - 1)[: b * maxp] + 1).reshape(b, maxp)
    lengths = np.array(_SPLIT_LENGTHS, np.int32)
    used = -(-lengths // page_size)
    table[np.arange(maxp)[None, :] >= used[:, None]] = 0
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    return q, pk, pv, table.astype(np.int32), lengths


@pytest.mark.parametrize("window", [0, 5, 70])
@pytest.mark.parametrize("page_size", [8, 16])
def test_decode_live_chunks_cover_what_the_reference_weighs(window,
                                                            page_size):
    """With each V row one-hot at its position, the JAX reference's
    output is every position's softmax weight: each weighted position
    lies in one of the kernel's live chunks, each live chunk holds one,
    and a row with no live chunk (length 0) gets zeros."""
    rng = np.random.default_rng(window + page_size)
    d = 160
    q, pk, pv, table, lengths = _split_case(rng, page_size, d)
    pv[:] = 0.0
    maxp = table.shape[1]
    for b in range(len(lengths)):
        for p in range(maxp):
            for s in range(page_size):
                if table[b, p]:
                    pv[table[b, p], s, :, p * page_size + s] = 1.0
    w = np.asarray(JREF.paged_attention_ref(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(lengths), window))
    chunk = TPA.DECODE_CHUNK
    for b, length in enumerate(lengths.tolist()):
        live = _live_chunks(length, window, maxp, page_size)
        weighed = np.flatnonzero((w[b] > 0).any(axis=0))
        assert sorted({t // chunk for t in weighed}) == list(live)
        if not live:
            assert np.all(w[b] == 0.0)
        assert np.allclose(w[b].sum(axis=-1), 1.0 if live else 0.0,
                           atol=1e-5)


def _split_kv_merge(q, pk, pv, table, lengths, window):
    """The split-KV decode's arithmetic in numpy: per live chunk the max,
    the weights' sum and the weighted V rows in the exp2 domain (scale x
    log2(e) folded into q), merged in chunk order."""
    b, hq, d = q.shape
    _, ps, nkv, _ = pk.shape
    g, maxp, chunk = hq // nkv, table.shape[1], TPA.DECODE_CHUNK
    k = pk[table].reshape(b, maxp * ps, nkv, d)
    v = pv[table].reshape(b, maxp * ps, nkv, d)
    out = np.zeros_like(q)
    qs = q * np.float32(np.log2(np.e) / np.sqrt(d))
    for r, length in enumerate(lengths.tolist()):
        lo = max(0, length - window) if window > 0 else 0
        hi = min(length, maxp * ps)
        for h in range(hq):
            parts = []
            for c in _live_chunks(length, window, maxp, ps):
                t = np.arange(c * chunk, (c + 1) * chunk)
                t = t[(t >= lo) & (t < hi)]
                s = k[r, t, h // g] @ qs[r, h]
                m = s.max()
                p = np.exp2(s - m)
                parts.append((m, p.sum(), p @ v[r, t, h // g]))
            if parts:
                mx = max(m for m, _, _ in parts)
                l = sum(lc * np.exp2(m - mx) for m, lc, _ in parts)
                acc = sum(a * np.exp2(m - mx) for m, _, a in parts)
                out[r, h] = acc / l
    return out


@pytest.mark.parametrize("window", [0, 5, 70])
@pytest.mark.parametrize("page_size", [8, 16])
def test_decode_split_kv_merge_vs_reference_and_pallas(window, page_size):
    """Chunks of 64 positions merged in chunk order (the kernel's two
    passes, on the rows of ``_SPLIT_LENGTHS``) give the JAX reference's
    and the Pallas kernel's output within 1e-5, and so does the port's
    plain version."""
    rng = np.random.default_rng(10 + window + page_size)
    q, pk, pv, table, lengths = _split_case(rng, page_size, 16)
    args = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray(table), jnp.asarray(lengths))
    want_ref = np.asarray(JREF.paged_attention_ref(*args, window))
    want_pl = np.asarray(JPA.paged_decode_attention(*args, jnp.int32(window),
                                                    interpret=True))
    got = _split_kv_merge(q, pk, pv, table, lengths, window)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_pl, rtol=0, atol=ATOL)
    assert np.all(got[0] == 0.0)
    plain = TPA.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(table),
                                       _t(lengths), window).numpy()
    np.testing.assert_allclose(plain, want_ref, rtol=0, atol=ATOL)


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
