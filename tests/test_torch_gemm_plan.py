"""The hashed GEMM's plan: which body runs a product, with which tiles,
split count and transient workspaces (``kernels/hashed_matmul.py``
``gemm_plan``), and the bank gradients' (``block_dw_plan``,
``element_dw_plan``: body, pieces a chain, fp32 workspace).

The plan is pure Python, so these tests run without a card: bf16
products of more than 8 rows take the tensor-core body (128 x 128 x 64
tiles, V decompressed once per call into a bf16 workspace of R x C x 2
bytes), except the element forward of at most 16 rows, which takes the
gemv body in either dtype (``tests/test_torch_decode_kernels.py``); fp32
and the decode-size transpose keep the CUDA-core body with the split
counts it had before the tensor-core body existed.  Exact equality
throughout: these are integers.  The kernels themselves are held against
their plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.core import hashed as TH
from repro_torch.kernels import hashed_matmul as THK

SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _old_split_count(m, k, n):
    """The CUDA-core body's split-K rule as the port had it before the
    plan existed: two waves of (column, row, split) blocks over the SMs,
    no split shorter than one 32-deep K tile."""
    bm = 8 if m <= 8 else 64
    blocks = -(-n // 64) * -(-m // bm)
    splits = 1
    while blocks * splits < 2 * SMS and (splits * 2) * 32 <= k:
        splits *= 2
    return splits


@pytest.mark.parametrize("m,want", [(1, "gemv"), (8, "gemv"),
                                    (16, "gemv"), (17, "tensor_core"),
                                    (1024, "tensor_core")])
def test_plan_body_follows_the_row_threshold(m, want):
    assert (THK.TC_MIN_ROWS, THK.GEMV_MAX_ROWS) == (9, 16)
    plan = THK.gemm_plan(m, 2048, 2048, "element", torch.bfloat16)
    assert plan.body == want
    assert (plan.bm, plan.bn, plan.bk) == \
        ((128, 128, 64) if want == "tensor_core" else (m, 256, 32))


@pytest.mark.parametrize("mode", ["element", "block"])
@pytest.mark.parametrize("m", [1, 8, 64, 1024])
def test_plan_fp32_keeps_the_cuda_core_body(mode, m):
    """fp32 never takes the tensor cores (no TF32): the CUDA-core body,
    except the element forward at decode size, whose gemv body keeps
    fp32 products too."""
    plan = THK.gemm_plan(m, 2048, 6144, mode, torch.float32, block_cols=128)
    assert plan.v_bytes == 0
    if mode == "element" and m <= 8:
        assert plan.body == "gemv"
        plan = THK.gemm_plan(m, 2048, 6144, mode, torch.float32,
                             transpose=True)
    assert plan.body == "cuda_core"
    assert plan.splits == _old_split_count(m, 2048, 6144)


@pytest.mark.parametrize("k,n", [(2048, 2048), (6144, 2048), (2048, 6144),
                                 (2048, 1024), (1024, 2048), (392, 648)])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_plan_decode_split_counts_unchanged(k, n, m):
    """The decode-size transpose (and a forced CUDA-core forward) keep
    the CUDA-core body's split counts."""
    plan = THK.gemm_plan(m, k, n, "element", torch.bfloat16, transpose=True)
    assert plan == THK.gemm_plan(m, k, n, "element", torch.bfloat16,
                                 body="cuda_core")
    assert plan.body == "cuda_core" and plan.bm == 8
    assert plan.splits == _old_split_count(m, k, n)
    assert plan.splitk_bytes == (plan.splits * m * n * 4
                                 if plan.splits > 1 else 0)


@pytest.mark.parametrize("mode", ["element", "block"])
@pytest.mark.parametrize("transpose", [False, True])
def test_plan_v_workspace_at_ffn_out(mode, transpose):
    """qwen3-1.7b's ffn.out V is 6144 x 2048: 25.2 MB of bf16, whichever
    orientation and mode; at M = 1024 no split-K partials."""
    k, n = (2048, 6144) if transpose else (6144, 2048)
    plan = THK.gemm_plan(1024, k, n, mode, torch.bfloat16, block_cols=128)
    assert plan.body == "tensor_core"
    assert plan.v_bytes == 6144 * 2048 * 2 == 25_165_824
    assert plan.splits == 1 and plan.splitk_bytes == 0
    assert plan.workspace_bytes == 25_165_824


# chip_smoke's shapes (qwen3-1.7b-hashed8: attn.q 2048 x 2048, ffn.out
# 6144 x 2048 both ways, attn.k 2048 x 1024 both ways) -> splits at
# M = 8 and 16 (the gemv body: 256-column blocks x splits within 132),
# 64, 256, 1024
SPLITS = {
    (2048, 2048): (16, 16, 8, 4, 1),
    (6144, 2048): (16, 16, 8, 4, 1),
    (2048, 6144): (5, 5, 2, 1, 1),
    (2048, 1024): (32, 32, 8, 8, 2),
    (1024, 2048): (16, 16, 4, 4, 1),
}


@pytest.mark.parametrize("kn", sorted(SPLITS))
def test_plan_split_counts_at_chip_smoke_shapes(kn):
    k, n = kn
    for m, want in zip((8, 16, 64, 256, 1024), SPLITS[kn]):
        plan = THK.gemm_plan(m, k, n, "element", torch.bfloat16)
        assert plan.splits == want, (m, k, n, plan)
        if plan.body == "tensor_core":
            blocks = -(-n // 128) * -(-m // 128)
            # at most one wave of blocks, no split under four K tiles
            assert blocks * plan.splits <= SMS or plan.splits == 1
            assert plan.splits == 1 or plan.splits * 4 * 64 <= k
            assert plan.workspace_bytes == k * n * 2 + (
                plan.splits * m * n * 4 if plan.splits > 1 else 0)


@pytest.mark.parametrize("m,k,n,block_cols", [(64, 2044, 2048, 0),
                                              (64, 2048, 2044, 0),
                                              (64, 2048, 2048, 12)])
def test_plan_ragged_chunks_take_the_cuda_core_body(m, k, n, block_cols):
    """The tensor-core body copies 16-byte chunks: K, N and a bank tile's
    columns must be multiples of 8."""
    mode = "block" if block_cols else "element"
    assert not THK.tensor_core_ok(m, k, n, torch.bfloat16, block_cols)
    assert THK.gemm_plan(m, k, n, mode, torch.bfloat16,
                         block_cols=block_cols).body == "cuda_core"
    with pytest.raises(ValueError, match="tensor-core body"):
        THK.gemm_plan(m, k, n, mode, torch.bfloat16, block_cols=block_cols,
                      body="tensor_core")


def test_plan_refuses_unknown_modes_and_bodies():
    with pytest.raises(ValueError):
        THK.gemm_plan(64, 256, 256, "dense", torch.bfloat16)
    with pytest.raises(ValueError):
        THK.gemm_plan(64, 256, 256, "element", torch.bfloat16, body="tf32")
    forced = THK.gemm_plan(1024, 256, 256, "element", torch.bfloat16,
                           body="cuda_core")
    assert forced.body == "cuda_core" and forced.v_bytes == 0


@pytest.mark.parametrize("mode", ["element", "block"])
def test_plan_is_ignored_on_the_cpu(mode):
    """A CPU tensor takes the plain version whatever plan is given."""
    if mode == "element":
        spec = TH.HashedSpec(virtual_shape=(64, 48), compression=0.25,
                             seed=3, panel_cols=16)
    else:
        spec = TH.HashedSpec(virtual_shape=(64, 48), compression=0.25,
                             seed=3, mode="block", block_shape=(16, 16))
    g = torch.Generator().manual_seed(0)
    w = torch.randn(spec.real_param_shape(), generator=g)
    x = torch.randn(20, 64, generator=g)
    plan = THK.gemm_plan(20, 64, 48, mode, torch.bfloat16, block_cols=16,
                         body="tensor_core")
    fn = THK.element_matmul if mode == "element" else THK.block_matmul
    assert torch.equal(fn(x, w, spec, plan=plan),
                       THK.hashed_matmul_ref(x, w, spec))


# ---------------------------------------------------------------------------
# block_dw: which body, how many pieces a bank tile's chain is cut into
# ---------------------------------------------------------------------------

def _block_specs():
    """qwen3-1.7b's projections hashed by a block-mode policy (128 x 128
    tiles, 1/8): specs only, no weights."""
    import repro_torch.configs as TC
    from repro_torch import policy
    from repro_torch.models.transformer import bank_spec_map
    cfg = TC.get("qwen3-1.7b").policy_variant(policy.CompressionPolicy(
        mode="block", block_shape=(128, 128), path="pallas"))
    return {path[-2]: spec for path, spec in bank_spec_map(cfg).items()}


# projection -> (bank tiles, splits at M = 1024)
DW_SPLITS = {"q": (32, 8), "k": (16, 8), "v": (16, 8), "o": (32, 8),
             "gate": (96, 4), "in": (96, 4), "out": (96, 4)}


@pytest.mark.parametrize("proj", sorted(DW_SPLITS))
def test_block_dw_plan_at_qwen3_projections(proj):
    """Every bf16 projection of a training step (M = 1024) takes the
    tensor cores; the splits are the most that keep the blocks within
    four waves over the SMs and each piece at least 16 K tiles of the
    mean chain (a wave nearly full at attn.k/v, 128 blocks); the
    workspace holds one fp32 bank per split."""
    spec = _block_specs()[proj]
    tiles, splits = DW_SPLITS[proj]
    assert spec.bank_tiles == tiles and spec.block_shape == (128, 128)
    plan = THK.block_dw_plan(1024, spec, torch.bfloat16)
    assert plan.body == "tensor_core" and plan.splits == splits
    assert plan.workspace_bytes == splits * tiles * 128 * 128 * 4
    gi, gj = spec.tile_grid
    steps = gi * gj * (1024 // 64) / tiles      # mean chain, K tiles
    assert 128 <= tiles * splits <= THK.DW_WAVES * SMS
    assert steps / splits >= THK.DW_MIN_STEPS
    assert tiles * splits * 2 > THK.DW_WAVES * SMS \
        or steps / (splits * 2) < THK.DW_MIN_STEPS


def test_block_dw_plan_workspace_at_attn_q_and_ffn_out():
    specs = _block_specs()
    assert THK.block_dw_plan(1024, specs["q"]).workspace_bytes \
        == 8 * 32 * 65536 == 16_777_216
    assert THK.block_dw_plan(1024, specs["out"]).workspace_bytes \
        == 4 * 96 * 65536 == 25_165_824


@pytest.mark.parametrize("m,splits", [(64, 1), (128, 1), (256, 2),
                                      (512, 4), (1024, 4), (4096, 4)])
def test_block_dw_plan_short_chains_split_less(m, splits):
    """ffn.out (96 bank tiles, 8 virtual tiles each on average): the mean
    chain is 8 x ceil(M / 64) K tiles; no piece under 16 of them, and at
    most four waves of blocks."""
    assert THK.block_dw_plan(m, _block_specs()["out"]).splits == splits


@pytest.mark.parametrize("dtype,block_shape", [
    (torch.float32, (128, 128)), (torch.float32, (32, 32)),
    (torch.bfloat16, (12, 16)), (torch.bfloat16, (16, 12))])
def test_block_dw_plan_cuda_core_for_fp32_and_ragged_tiles(dtype,
                                                          block_shape):
    """fp32 keeps full fp32 products on the CUDA cores; bank tiles whose
    rows or columns are not whole 16-byte chunks cannot be copied by the
    tensor-core body, and forcing it refuses."""
    spec = TH.HashedSpec(virtual_shape=(96, 96), compression=0.25, seed=1,
                         mode="block", block_shape=block_shape)
    assert not THK.block_dw_ok(64, block_shape, dtype)
    assert THK.block_dw_plan(64, spec, dtype) == THK.DwPlan(
        "cuda_core", 1, 0)
    with pytest.raises(ValueError, match="tensor-core block_dw"):
        THK.block_dw_plan(64, spec, dtype, body="tensor_core")


def test_block_dw_plan_forced_and_refused():
    spec = _block_specs()["q"]
    plan = THK.block_dw_plan(1024, spec, body="tensor_core", splits=3)
    assert plan == THK.DwPlan("tensor_core", 3, 3 * 32 * 65536)
    assert THK.block_dw_plan(1024, spec, splits=1).workspace_bytes == 0
    assert THK.block_dw_plan(1024, spec, body="cuda_core") \
        == THK.DwPlan("cuda_core", 1, 0)
    with pytest.raises(ValueError):
        THK.block_dw_plan(1024, spec, body="cuda_core", splits=2)
    with pytest.raises(ValueError):
        THK.block_dw_plan(1024, spec, splits=0)
    with pytest.raises(ValueError):
        THK.block_dw_plan(1024, spec, body="tf32")
    with pytest.raises(ValueError):
        THK.block_dw_plan(1024, TH.HashedSpec(virtual_shape=(64, 64),
                                              compression=0.25))


def test_block_tables_chain_order():
    """The chains ``block_dw`` walks: the virtual tiles of bank tile b are
    ``order[offsets[b]:offsets[b + 1]]``, in ascending position (the JAX
    kernel's stable argsort), every tile once."""
    spec = TH.HashedSpec(virtual_shape=(768, 1152), compression=0.5, seed=0,
                         mode="block", block_shape=(128, 128))
    idx, sgn, order, offsets, _ = THK.block_tables(spec, "cpu")
    bank_idx, bank_sgn = TH.block_indices(spec, "cpu")
    assert idx.tolist() == bank_idx.reshape(-1).tolist()
    assert sgn.tolist() == bank_sgn.reshape(-1).tolist()
    assert sorted(order.tolist()) == list(range(spec.num_tiles))
    assert offsets[0] == 0 and offsets[-1] == spec.num_tiles
    for b in range(spec.bank_tiles):
        chain = order[offsets[b]:offsets[b + 1]].tolist()
        assert chain == sorted(chain)
        assert all(idx[t] == b for t in chain)
    assert {t.dtype for t in (idx, sgn, order, offsets)} == {torch.int32}


def test_counts_report_tensor_core_launches():
    """``kernels.counts`` reports the tensor-core launches of ``block_dw``
    and the prefill beside their launches; ``reset_counts`` clears them."""
    from repro_torch import kernels as K
    from repro_torch.kernels import flash_prefill as TFP
    K.reset_counts()
    THK.block_dw.tensor_core, TFP.paged_prefill_attention.tensor_core = 3, 2
    c = K.counts()
    assert c["block_dw"]["tensor_core"] == 3
    assert c["paged_prefill"]["tensor_core"] == 2
    K.reset_counts()
    c = K.counts()
    assert c["block_dw"] == {"launches": 0, "plain_cuda_calls": 0,
                             "tensor_core": 0}
    assert c["paged_prefill"]["tensor_core"] == 0


def test_block_tables_launch_longest_chains_first():
    """``heavy`` lists every bank tile once, by descending number of
    virtual tiles (ties in bank order): the longest pieces start in the
    first wave."""
    spec = TH.HashedSpec(virtual_shape=(768, 1152), compression=0.5, seed=0,
                         mode="block", block_shape=(128, 128))
    _, _, order, offsets, heavy = THK.block_tables(spec, "cpu")
    lengths = (offsets[1:] - offsets[:-1]).tolist()
    hv = heavy.tolist()
    assert sorted(hv) == list(range(spec.bank_tiles))
    assert [lengths[b] for b in hv] == sorted(lengths, reverse=True)
    for a, b in zip(hv, hv[1:]):
        assert lengths[a] > lengths[b] or a < b
    assert heavy.dtype == order.dtype == torch.int32


def test_block_dw_plan_is_ignored_on_the_cpu():
    spec = TH.HashedSpec(virtual_shape=(64, 48), compression=0.25, seed=3,
                         mode="block", block_shape=(16, 16))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(20, 64, generator=g)
    gy = torch.randn(20, 48, generator=g)
    plan = THK.block_dw_plan(20, spec, torch.bfloat16, splits=4)
    assert torch.equal(THK.block_dw(x, gy, spec, plan=plan),
                       THK.hashed_dw_ref(x, gy, spec))


# ---------------------------------------------------------------------------
# element_dw: which body, how many pieces M is cut into
# ---------------------------------------------------------------------------

def _element_specs():
    """qwen3-1.7b-hashed8's element-mode projections: specs only."""
    import repro_torch.configs as TC
    from repro_torch.models.transformer import bank_spec_map
    cfg = TC.get("qwen3-1.7b-hashed8")
    return {path[-2]: spec for path, spec in bank_spec_map(cfg).items()}


ELEMENT_SHAPES = {"q": (2048, 2048), "k": (2048, 1024), "v": (2048, 1024),
                  "o": (2048, 2048), "gate": (2048, 6144),
                  "in": (2048, 6144), "out": (6144, 2048)}


@pytest.mark.parametrize("proj", sorted(ELEMENT_SHAPES))
def test_element_dw_plan_at_qwen3_projections(proj):
    """Every bf16 projection of a training step (M = 1024) takes x^T g on
    the tensor cores in one piece: 16 K tiles of M, no shorter piece
    allowed, and 128 (attn.k/v) to 768 (the FFN) output tiles of
    128 x 128 already fill the SMs; no split workspace."""
    spec = _element_specs()[proj]
    assert spec.mode == "element"
    assert spec.virtual_shape == ELEMENT_SHAPES[proj]
    assert THK.element_dw_plan(1024, spec, torch.bfloat16) \
        == THK.DwPlan("tensor_core", 1, 0)
    r, c = spec.virtual_shape
    assert 128 <= (r // 128) * (c // 128) <= 768


@pytest.mark.parametrize("m,splits", [(64, 1), (200, 1), (1024, 1),
                                      (2048, 2), (4096, 4), (16384, 4)])
def test_element_dw_plan_splits_only_long_m(m, splits):
    """attn.k (2048 x 1024: 128 output tiles): M is cut into pieces only
    while each keeps 16 K tiles and the blocks stay within four waves."""
    spec = _element_specs()["k"]
    plan = THK.element_dw_plan(m, spec)
    assert plan.splits == splits
    assert plan.workspace_bytes == (splits * 2048 * 1024 * 4
                                    if splits > 1 else 0)


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (768, 1024)),
                                         (torch.bfloat16, (100, 64)),
                                         (torch.bfloat16, (64, 100))])
def test_element_dw_plan_cuda_core_for_fp32_and_ragged_shapes(dtype, shape):
    """fp32 keeps full fp32 products on the CUDA cores; rows or columns
    that are not whole 16-byte chunks cannot be staged by the tensor-core
    body, and forcing it refuses."""
    spec = TH.HashedSpec(virtual_shape=shape, compression=0.25, seed=1)
    assert THK.element_dw_plan(64, spec, dtype) == THK.DwPlan(
        "cuda_core", 1, 0)
    with pytest.raises(ValueError, match="tensor-core element_dw"):
        THK.element_dw_plan(64, spec, dtype, body="tensor_core")


def test_element_dw_plan_forced_and_refused():
    spec = TH.HashedSpec(virtual_shape=(768, 1024), compression=0.125)
    assert THK.element_dw_plan(200, spec, body="tensor_core", splits=3) \
        == THK.DwPlan("tensor_core", 3, 3 * 768 * 1024 * 4)
    assert THK.element_dw_plan(200, spec, body="cuda_core") \
        == THK.DwPlan("cuda_core", 1, 0)
    with pytest.raises(ValueError):
        THK.element_dw_plan(200, spec, body="cuda_core", splits=2)
    with pytest.raises(ValueError):
        THK.element_dw_plan(200, spec, splits=0)
    with pytest.raises(ValueError):
        THK.element_dw_plan(200, spec, body="tf32")
    with pytest.raises(ValueError):
        THK.element_dw_plan(200, TH.HashedSpec(
            virtual_shape=(64, 64), compression=0.25, mode="block",
            block_shape=(16, 16)))


def test_element_dw_plan_is_ignored_on_the_cpu():
    spec = TH.HashedSpec(virtual_shape=(64, 48), compression=0.25, seed=3,
                         panel_cols=16)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(20, 64, generator=g)
    gy = torch.randn(20, 48, generator=g)
    plan = THK.element_dw_plan(20, spec, torch.bfloat16, splits=4)
    assert torch.equal(THK.element_dw(x, gy, spec, plan=plan),
                       THK.hashed_dw_ref(x, gy, spec))


def test_counts_report_element_dw_tensor_core_launches():
    """``kernels.counts`` reports ``element_dw``'s tensor-core launches
    under ``hashed_dw``; ``reset_counts`` clears them."""
    from repro_torch import kernels as K
    K.reset_counts()
    THK.element_dw.tensor_core = 5
    assert K.counts()["hashed_dw"]["tensor_core"] == 5
    K.reset_counts()
    assert K.counts()["hashed_dw"] == {"launches": 0, "plain_cuda_calls": 0,
                                       "tensor_core": 0}
