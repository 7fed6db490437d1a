"""The hashed GEMM's plan: which body runs a product, with which tiles,
split count and transient workspaces (``kernels/hashed_matmul.py``
``gemm_plan``).

The plan is pure Python, so these tests run without a card: bf16
products of more than 8 rows take the tensor-core body (128 x 128 x 64
tiles, V decompressed once per call into a bf16 workspace of R x C x 2
bytes); decode (M <= 8) and fp32 keep the CUDA-core body with the split
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


@pytest.mark.parametrize("m,want", [(1, "cuda_core"), (8, "cuda_core"),
                                    (9, "tensor_core"), (16, "tensor_core"),
                                    (1024, "tensor_core")])
def test_plan_body_follows_the_row_threshold(m, want):
    assert THK.TC_MIN_ROWS == 9
    plan = THK.gemm_plan(m, 2048, 2048, "element", torch.bfloat16)
    assert plan.body == want
    assert (plan.bm, plan.bn, plan.bk) == \
        ((128, 128, 64) if want == "tensor_core" else (8, 64, 32)
         if m <= 8 else (64, 64, 32))


@pytest.mark.parametrize("mode", ["element", "block"])
@pytest.mark.parametrize("m", [1, 8, 64, 1024])
def test_plan_fp32_keeps_the_cuda_core_body(mode, m):
    plan = THK.gemm_plan(m, 2048, 6144, mode, torch.float32, block_cols=128)
    assert plan.body == "cuda_core" and plan.v_bytes == 0
    assert plan.splits == _old_split_count(m, 2048, 6144)


@pytest.mark.parametrize("k,n", [(2048, 2048), (6144, 2048), (2048, 6144),
                                 (2048, 1024), (1024, 2048), (392, 648)])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_plan_decode_split_counts_unchanged(k, n, m):
    plan = THK.gemm_plan(m, k, n, "element", torch.bfloat16)
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
# M = 8, 16, 64, 256, 1024
SPLITS = {
    (2048, 2048): (16, 8, 8, 4, 1),
    (6144, 2048): (16, 8, 8, 4, 1),
    (2048, 6144): (4, 2, 2, 1, 1),
    (2048, 1024): (32, 8, 8, 8, 2),
    (1024, 2048): (16, 4, 4, 4, 1),
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
