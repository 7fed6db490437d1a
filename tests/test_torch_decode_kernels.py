"""The decode-size kernels' host-side logic, on the CPU.

``csrc/hashed_matmul.cu``'s gemv body (the element forward at M <= 8)
and ``csrc/topk.cu``'s cluster radix select run only on the card
(``tests/test_torch_cuda.py``); what decides how they run is Python and
integer arithmetic, held here exactly:

- ``bucket_magic``: the multiply-high bucket reduction, emulated in
  Python integers as the kernel computes it, equals ``h % kp``;
- ``gemm_plan``: which products take the gemv body, its row block, its
  split count and workspace, and that it fills the card's 132 SMs at
  qwen3-1.7b's widths; the entry point does not pad decode-size rows;
- ``topk_plan``: cluster size, slices, shared memory, where streaming
  starts; and an emulation of the sliced radix select (per-slice
  histograms summed, a digit chosen per pass) bitwise equal to
  ``topk_mask_ref``;
- ``kernels.counts``: the new per-body and resident counts.
"""
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch import kernels as K
from repro_torch.core import hashed as TH
from repro_torch.kernels import hashed_matmul as THK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import topk as TTK
from repro_torch.models.transformer import bank_spec_map


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the bucket reduction
# ---------------------------------------------------------------------------

def _kp_cases():
    """Every buckets_per_panel of the full-width and reduced configs, and
    edge counts."""
    kps = {1, 2, 3, 2 ** 17, 2 ** 31 + 1, 2 ** 32 - 1}
    for name in ("qwen3-1.7b-hashed8", "qwen3-1.7b-reduced-hashed8"):
        kps |= {s.buckets_per_panel
                for s in bank_spec_map(TC.get(name)).values()}
    return sorted(kps)


def _bucket_mod(h: int, kp: int, magic: int) -> int:
    """rt::bucket_mod as the kernel computes it in uint32 arithmetic:
    q = mulhi(h, magic), r = h - q * kp, then the unsigned min of r and
    r - kp (wrapped)."""
    m32 = 2 ** 32 - 1
    r = (h - ((h * magic) >> 32) * kp) & m32
    return min(r, (r - kp) & m32)


@pytest.mark.parametrize("kp", _kp_cases())
def test_bucket_magic_reduction_is_exact(kp):
    magic = THK.bucket_magic(kp)
    assert 0 <= magic < 2 ** 32
    rng = np.random.default_rng(kp % 2 ** 32)
    hs = [0, 1, kp - 1, kp, 2 ** 31, 2 ** 32 - 1] \
        + rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64).tolist()
    for h in hs:
        if h < 2 ** 32:
            assert _bucket_mod(h, kp, magic) == h % kp, (h, kp)


def test_bucket_magic_refuses_counts_outside_uint32():
    for kp in (0, -1, 2 ** 32):
        with pytest.raises(ValueError):
            THK.bucket_magic(kp)


# ---------------------------------------------------------------------------
# the gemv plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 3, 5, 8, 16])
def test_plan_gemv_takes_the_decode_size_element_forward(m, dtype):
    plan = THK.gemm_plan(m, 2048, 6144, "element", dtype)
    assert plan.body == "gemv" and plan.v_bytes == 0
    assert plan.bm == {1: 1, 2: 2, 3: 4, 5: 8, 8: 8, 16: 16}[m]
    assert (plan.bn, plan.bk) == (THK.GEMV_COLS, THK.GEMV_KSTEP)
    # not the transpose, not block mode
    small = "cuda_core" if m < THK.TC_MIN_ROWS or dtype == torch.float32 \
        else "tensor_core"
    assert THK.gemm_plan(m, 6144, 2048, "element", dtype,
                         transpose=True).body == small
    assert THK.gemm_plan(m, 2048, 6144, "block", dtype,
                         block_cols=128).body == small
    # the workspace the wrapper allocates is the plan's
    y, ws, vws = THK._gemm_out(torch.zeros(m, 2048, dtype=dtype), 6144,
                               plan)
    assert vws is None and y.shape == (m, 6144)
    got = ws.numel() * ws.element_size() if ws is not None else 0
    assert got == plan.splitk_bytes == plan.workspace_bytes \
        == plan.splits * m * 6144 * 4


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_gemv_stops_at_its_largest_row_block(dtype):
    m = THK.GEMV_MAX_ROWS
    assert THK.gemm_plan(m, 2048, 2048, "element", dtype).body == "gemv"
    assert THK.gemm_plan(m + 1, 2048, 2048, "element", dtype).body == (
        "tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    # the transpose keeps the tensor cores from TC_MIN_ROWS on
    assert THK.gemm_plan(THK.TC_MIN_ROWS, 2048, 2048, "element", dtype,
                         transpose=True).body == (
        "tensor_core" if dtype == torch.bfloat16 else "cuda_core")


def test_plan_gemv_forced_and_refused():
    forced = THK.gemm_plan(16, 2048, 2048, "element", torch.bfloat16,
                           body="gemv")
    assert forced.body == "gemv" and forced.bm == THK.GEMV_MAX_ROWS == 16
    for m, mode, transpose in ((17, "element", False), (0, "element", False),
                               (8, "element", True), (8, "block", False)):
        with pytest.raises(ValueError, match="gemv"):
            THK.gemm_plan(m, 2048, 2048, mode, torch.bfloat16,
                          block_cols=128, transpose=transpose, body="gemv")


# the four projection shapes of a decode step (K, N)
DECODE_SHAPES = {"attn.k": (2048, 1024), "attn.q": (2048, 2048),
                 "ffn.up": (2048, 6144), "ffn.out": (6144, 2048)}


@pytest.mark.parametrize("proj", sorted(DECODE_SHAPES))
def test_plan_gemv_fills_the_sms(proj):
    """One block of 256 columns and one K split per SM: between 120 and
    132 blocks at each projection, every split whole K steps and none
    empty."""
    k, n = DECODE_SHAPES[proj]
    for m in (1, 4, 8):
        plan = THK.gemm_plan(m, k, n, "element", torch.bfloat16)
        blocks = -(-n // THK.GEMV_COLS) * plan.splits
        assert 120 <= blocks <= 132, (proj, plan)
        per = -(-(-(-k // plan.splits)) // THK.GEMV_KSTEP) * THK.GEMV_KSTEP
        assert (plan.splits - 1) * per < k <= plan.splits * per


def test_decode_size_element_forward_is_not_padded(monkeypatch):
    """The entry point hands the gemv body its true row count (M a
    template); products of more than GEMV_MAX_ROWS rows are padded as
    before."""
    seen = []
    real = THK.element_matmul

    def spy(x, w, spec, **kw):
        seen.append(x.shape[0])
        return real(x, w, spec, **kw)

    monkeypatch.setattr(THK, "element_matmul", spy)
    spec = TH.HashedSpec(virtual_shape=(64, 48), compression=0.25, seed=3,
                         panel_cols=16)
    g = torch.Generator().manual_seed(0)
    w = torch.randn(spec.num_buckets, generator=g)
    for shape in ((1, 64), (3, 64), (2, 4, 64), (9, 64), (16, 64),
                  (20, 64)):
        x = torch.randn(*shape, generator=g)
        y = TOPS.hashed_matmul(x, w, spec)
        assert y.shape == (*shape[:-1], 48)
        torch.testing.assert_close(
            y, THK.hashed_matmul_ref(x.reshape(-1, 64), w, spec)
            .reshape(*shape[:-1], 48), rtol=0, atol=0)
    assert seen == [1, 3, 8, 9, 16, 32]


def test_counts_report_gemv_and_resident_launches():
    K.reset_counts()
    THK.element_matmul.gemv, THK.element_matmul.tensor_core = 4, 3
    THK.element_matmul.small = 4
    TTK.topk_mask.resident = 2
    c = K.counts()
    assert (c["hashed_matmul"]["gemv"], c["hashed_matmul"]["tensor_core"],
            c["hashed_matmul"]["small"]) == (4, 3, 4)
    assert c["topk_mask"]["resident"] == 2
    K.reset_counts()
    c = K.counts()
    assert c["hashed_matmul"] == {"launches": 0, "plain_cuda_calls": 0,
                                  "tensor_core": 0, "gemv": 0,
                                  "small": 0}
    assert c["topk_mask"] == {"launches": 0, "plain_cuda_calls": 0,
                              "resident": 0}


# ---------------------------------------------------------------------------
# the top-k plan and the sliced radix select
# ---------------------------------------------------------------------------

def test_topk_plan_at_full_width():
    v = 151936
    hist = (16 + 3) * 256 * 4
    assert TTK.HIST_BYTES == hist
    p = TTK.topk_plan(8, v, torch.float32, cluster=16)
    assert (p.cluster, p.slice, p.resident) == (16, 9496, True)
    assert p.shared_bytes == hist + 9496 * 4
    p = TTK.topk_plan(64, v, torch.bfloat16, cluster=8)
    assert (p.slice, p.resident, p.shared_bytes) == \
        (18992, True, hist + 18992 * 2)
    p = TTK.topk_plan(1, v, torch.float32, cluster=1)
    assert not p.resident and p.shared_bytes == hist and p.slice == v
    # slices of whole 16-byte copies
    assert TTK.topk_plan(3, 1001, torch.float32, cluster=8).slice == 128
    default = TTK.topk_plan(8, v)
    assert default.cluster == TTK.default_plan(8, v, torch.float32)
    assert default.resident


@pytest.mark.parametrize("b,dtype,want", [
    (1, torch.float32, 16), (4, torch.float32, 16),
    (8, torch.float32, 8), (16, torch.bfloat16, 4),
    (64, torch.float32, 4), (64, torch.bfloat16, 2)])
def test_topk_default_plan_by_batch(b, dtype, want):
    """Past 32 rows the fewest CTAs that still hold a 151936-wide row:
    4 in fp32, 2 in bf16."""
    assert TTK.default_plan(b, 151936, dtype) == want
    assert TTK.topk_plan(b, 151936, dtype).resident


@pytest.mark.parametrize("cluster,dtype,want", [
    (16, torch.float32, 847_873), (8, torch.float32, 423_937),
    (2, torch.float32, 105_985), (16, torch.bfloat16, 1_695_745)])
def test_topk_streaming_starts_where_slices_overflow(cluster, dtype, want):
    assert TTK.streaming_from(cluster, dtype) == want
    assert TTK.topk_plan(1, want - 1, dtype, cluster=cluster).resident
    assert TTK.topk_plan(1, want - 1, dtype, cluster=cluster).shared_bytes \
        <= TTK.SMEM_LIMIT
    assert not TTK.topk_plan(1, want, dtype, cluster=cluster).resident


def test_topk_plan_refuses_unknown_sizes():
    for dtype, kw in ((torch.float32, dict(cluster=3)),
                      (torch.float32, dict(cluster=32)),
                      (torch.float16, {})):
        with pytest.raises(ValueError):
            TTK.topk_plan(8, 1000, dtype, **kw)


# the shifts of the kernel's four 8-bit digits, from the top
SHIFTS = (24, 16, 8, 0)


def _ukey(x32: np.ndarray) -> np.ndarray:
    x = np.where(x32 == 0, np.float32(0), x32).astype(np.float32)
    i = x.view(np.uint32)
    return np.where(i & 0x80000000, ~i, i | 0x80000000).astype(np.uint32)


def _sliced_select(row32: np.ndarray, k: int, cluster: int):
    """topk_cluster's threshold as the kernel finds it: the row cut into
    ``cluster`` slices, per pass each slice's histogram of candidate
    digits, the histograms summed, the digit holding the krem-th largest
    chosen by a scan from the top.  None for a disabled row."""
    v = row32.size
    if k <= 0 or k >= v:
        return None
    sl = TTK.topk_plan(1, v, torch.float32, cluster=cluster).slice
    keys = _ukey(row32)
    slices = [keys[r * sl:(r + 1) * sl] for r in range(cluster)]
    nb, dm = 256, 255
    prefix = mask = 0
    krem = k
    for shift in SHIFTS:
        tot = np.zeros(nb, np.int64)
        for s in slices:
            cand = s[(s & mask) == prefix]
            tot += np.bincount((cand >> shift) & dm, minlength=nb)
        desc = tot[::-1]
        cum = np.cumsum(desc)
        pos = int(np.searchsorted(cum, krem))      # first cum >= krem
        krem -= int(cum[pos] - desc[pos])
        prefix |= (nb - 1 - pos) << shift
        mask |= dm << shift
    return prefix


def _topk_rows(v: int):
    """chip_smoke phase 3d's rows at width v, and a k = v - 1 row."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((9, v)).astype(np.float32)
    x[2, :100] = 3.5                      # ties at the threshold
    x[3, ::2] = 0.0                       # +-0.0 at the threshold
    x[3, 1::2] = -0.0
    x[3, :10] = 1.0
    k = np.array([0, 1, 50, 50, v, 20, 50, 7, v - 1], np.int32)
    return torch.from_numpy(x), torch.from_numpy(k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [1000, 1003])    # 1003: no whole 16-byte rows
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_sliced_radix_select_matches_plain_version_bitwise(cluster, v,
                                                           dtype):
    x, k = _topk_rows(v)
    x = x.to(dtype)
    x32 = x.float().numpy()
    out = x.clone()
    fill = torch.tensor(TTK.NEG, dtype=dtype)
    for r in range(x.shape[0]):
        thr = _sliced_select(x32[r], int(k[r]), cluster)
        if thr is not None:
            keep = torch.from_numpy(_ukey(x32[r]) >= thr)
            out[r] = torch.where(keep, x[r], fill)
    want = TTK.topk_mask_ref(x, k)
    assert torch.equal(out, want)
    assert bool((out[3] != TTK.NEG).all())        # every +-0.0 tie kept
    assert int((out[2] != fill).sum()) == 100     # all 100 ties kept
