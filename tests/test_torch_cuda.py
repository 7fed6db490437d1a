"""The CUDA kernels of the PyTorch port against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances: fp32
max error <= 1e-5 x the largest plain value (the sums run in another
order); bf16 <= 1e-2 x (one rounding of the output); ``dw`` (fp32 out)
1e-5, and bitwise equal to itself across two launches; the top-k mask
bitwise; a small model's training step as stated in its test.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import hashed as TH
from repro_torch.kernels import flash_prefill as TFP
from repro_torch.kernels import hashed_matmul as THK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import topk as TTK


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _topk_case():
    rng = np.random.default_rng(3)
    v = 200
    x = rng.standard_normal((6, v)).astype(np.float32)
    x[2, :30] = 1.25                  # ties straddling the threshold
    x[3] = 0.0
    x[3, 1::2] = -0.0                 # +-0.0 at the threshold
    x[3, :5] = 2.0
    k = np.array([0, -3, 10, 20, v, 1], np.int32)   # k<=0, k>=V disable
    return torch.from_numpy(x), torch.from_numpy(k)


# the paper's MLP layers (784-1000-...-10, compression 1/64, one global
# bucket space): fp32 at the minibatch of 50 rows
MLP_SHAPES = [(784, 1000), (1000, 1000), (1000, 10)]
FWD_CASES = ([(m, dtype, (1024, 768), 0.125, panel_cols)
              for panel_cols in (256, 0) for m in (1, 8, 37, 256)
              for dtype in (torch.float32, torch.bfloat16)]
             + [(50, torch.float32, shape, 1 / 64, 0) for shape in MLP_SHAPES]
             + [(2000, torch.float32, (784, 1000), 1 / 64, 0)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,dtype,shape,compression,panel_cols", FWD_CASES)
def test_cuda_hashed_matmul_vs_plain(cuda_device, m, dtype, shape,
                                     compression, panel_cols):
    spec = TH.HashedSpec(virtual_shape=shape, compression=compression,
                         seed=9, panel_cols=panel_cols)
    g = torch.Generator(device=cuda_device).manual_seed(m)
    w = torch.randn(spec.num_buckets, generator=g, device=cuda_device) \
        .to(dtype)
    x = torch.randn(m, shape[0], generator=g, device=cuda_device).to(dtype)
    before = THK.element_matmul.launches
    got = TOPS.hashed_matmul(x, w, spec)
    assert THK.element_matmul.launches == before + 1
    want = THK.hashed_matmul_ref(x, w, spec)
    scale = want.float().abs().max().item()
    # fp32: sum order only; bf16: one rounding of the output
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


def _max_err(got, want):
    got, want = got.float(), want.float()
    return (got - want).abs().max().item(), want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,panel_cols,dtype,shape,compression",
    [(m, panel_cols, dtype, (768, 1024), 0.125) for m in (1, 37, 256)
     for panel_cols in (0, 256)
     for dtype in (torch.float32, torch.bfloat16)]
    + [(50, 0, torch.float32, shape, 1 / 64) for shape in MLP_SHAPES])
def test_cuda_element_dx_vs_plain(cuda_device, m, panel_cols, dtype, shape,
                                  compression):
    spec = TH.HashedSpec(virtual_shape=shape, compression=compression,
                         seed=4, panel_cols=panel_cols)
    g = torch.Generator(device=cuda_device).manual_seed(m)
    w = torch.randn(spec.num_buckets, generator=g, device=cuda_device) \
        .to(dtype)
    gy = torch.randn(m, shape[1], generator=g, device=cuda_device).to(dtype)
    before = THK.element_matmul_t.launches
    got = THK.element_matmul_t(gy, w, spec)
    assert THK.element_matmul_t.launches == before + 1
    assert got.shape == (m, shape[0]) and got.dtype == dtype
    err, scale = _max_err(got, THK.hashed_matmul_t_ref(gy, w, spec))
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * scale


@pytest.mark.cuda
@pytest.mark.parametrize(
    "panel_cols,dtype,shape,compression,m",
    [(panel_cols, dtype, (768, 1024), 0.125, 200) for panel_cols in (0, 256)
     for dtype in (torch.float32, torch.bfloat16)]
    + [(0, torch.float32, shape, 1 / 64, 50) for shape in MLP_SHAPES])
def test_cuda_element_dw_vs_plain_and_bitwise_repeatable(
        cuda_device, panel_cols, dtype, shape, compression, m):
    """dw is fp32 in both; the kernel sums each bucket in a fixed order,
    so two launches give the same bits."""
    spec = TH.HashedSpec(virtual_shape=shape, compression=compression,
                         seed=8, panel_cols=panel_cols)
    g = torch.Generator(device=cuda_device).manual_seed(panel_cols)
    x = torch.randn(m, shape[0], generator=g, device=cuda_device).to(dtype)
    gy = torch.randn(m, shape[1], generator=g, device=cuda_device).to(dtype)
    got = THK.element_dw(x, gy, spec)
    again = THK.element_dw(x, gy, spec)
    assert got.dtype == torch.float32 and got.shape == (spec.num_buckets,)
    assert torch.equal(got, again)
    err, scale = _max_err(got, THK.hashed_dw_ref(x, gy, spec))
    assert err <= 1e-5 * scale


def _element_dw_case(cuda_device, shape, m, panel_cols, use_sign=True):
    spec = TH.HashedSpec(virtual_shape=shape, compression=0.125, seed=8,
                         panel_cols=panel_cols, use_sign=use_sign)
    g = torch.Generator(device=cuda_device).manual_seed(m + panel_cols)
    x = torch.randn(m, shape[0], generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    gy = torch.randn(m, shape[1], generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    return spec, x, gy


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 200, 1024])
@pytest.mark.parametrize("panel_cols", [0, 256])
@pytest.mark.parametrize("shape,use_sign", [((768, 1024), True),
                                            ((392, 648), False)])
def test_cuda_element_dw_tensor_core_vs_plain(cuda_device, m, panel_cols,
                                              shape, use_sign):
    """bf16 element dw with x^T g on the tensor cores (one R x C bank
    tile; 200 rows end inside a 64-row step; 392 x 648 ends inside a
    128 x 128 output tile), the signs applied by the segment pass; within
    1e-5 x the largest plain value (fp32 sums in another order), bitwise
    equal to itself across launches, counted as a tensor-core launch."""
    spec, x, gy = _element_dw_case(cuda_device, shape, m, panel_cols,
                                   use_sign)
    assert THK.element_dw_plan(m, spec).body == "tensor_core"
    before = THK.element_dw.launches, THK.element_dw.tensor_core
    got = THK.element_dw(x, gy, spec)
    assert (THK.element_dw.launches, THK.element_dw.tensor_core) \
        == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.float32 and got.shape == (spec.num_buckets,)
    assert torch.equal(got, THK.element_dw(x, gy, spec))
    err, scale = _max_err(got, THK.hashed_dw_ref(x, gy, spec))
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("body,splits", [("tensor_core", 1),
                                         ("tensor_core", 3),
                                         ("tensor_core", 8),
                                         ("cuda_core", 1)])
def test_cuda_element_dw_forced_plans_vs_plain(cuda_device, body, splits):
    """Forced plans at M = 200 (4 row steps): one piece, 3 uneven pieces
    over M, 8 pieces (more than the steps, so some are empty and add
    zeros), and the CUDA-core body on bf16; each within 1e-5 x scale of
    the plain version and bitwise repeatable."""
    spec, x, gy = _element_dw_case(cuda_device, (768, 1024), 200, 256)
    plan = THK.element_dw_plan(200, spec, body=body, splits=splits)
    before = THK.element_dw.tensor_core
    got = THK.element_dw(x, gy, spec, plan=plan)
    assert THK.element_dw.tensor_core == before + (body == "tensor_core")
    assert torch.equal(got, THK.element_dw(x, gy, spec, plan=plan))
    err, scale = _max_err(got, THK.hashed_dw_ref(x, gy, spec))
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("m", [3, 8, 130])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_block_matmul_vs_plain(cuda_device, m, transpose, dtype):
    spec = TH.HashedSpec(virtual_shape=(768, 1024), compression=0.125,
                         seed=5, mode="block", block_shape=(128, 64))
    g = torch.Generator(device=cuda_device).manual_seed(m)
    w = torch.randn(spec.real_param_shape(), generator=g,
                    device=cuda_device).to(dtype)
    k = spec.cols if transpose else spec.rows
    x = torch.randn(m, k, generator=g, device=cuda_device).to(dtype)
    before = THK.block_matmul.launches
    got = THK.block_matmul(x, w, spec, transpose=transpose)
    assert THK.block_matmul.launches == before + 1
    ref = THK.hashed_matmul_t_ref if transpose else THK.hashed_matmul_ref
    err, scale = _max_err(got, ref(x, w, spec))
    assert err <= (1e-5 if dtype == torch.float32 else 1e-2) * scale


def _tc_case(cuda_device, spec, m, transpose, seed):
    """bf16 x and bank for a tensor-core GEMM of ``m`` rows."""
    g = torch.Generator(device=cuda_device).manual_seed(seed)
    w = torch.randn(spec.real_param_shape(), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    k = spec.cols if transpose else spec.rows
    x = torch.randn(m, k, generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    return x, w


def _check_tc(got, again, want, plan):
    """Tensor-core body, one rounding of the bf16 output (1e-2 x the
    largest plain value), same bits on a second launch."""
    assert plan.body == "tensor_core"
    err, scale = _max_err(got, want)
    assert err <= 1e-2 * scale
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 64, 130, 1024])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("panel_cols", [0, 256])
def test_cuda_element_tensor_core_gemm_vs_plain(cuda_device, m, transpose,
                                                panel_cols):
    """bf16 element-mode GEMM of 16 rows or more on the tensor cores, both
    orientations: K and N (392, 648) are not multiples of the 64 x 128
    tiles, and the 256-column panels end inside a tile."""
    spec = TH.HashedSpec(virtual_shape=(392, 648), compression=0.125,
                         seed=11, panel_cols=panel_cols)
    x, w = _tc_case(cuda_device, spec, m, transpose, m + panel_cols)
    k, n = (spec.cols, spec.rows) if transpose else (spec.rows, spec.cols)
    # forced: the forward of 16 rows takes the gemv body by default
    plan = THK.gemm_plan(m, k, n, "element", torch.bfloat16,
                         transpose=transpose, body="tensor_core")
    fn = THK.element_matmul_t if transpose else THK.element_matmul
    ref = THK.hashed_matmul_t_ref if transpose else THK.hashed_matmul_ref
    _check_tc(fn(x, w, spec, plan=plan), fn(x, w, spec, plan=plan),
              ref(x, w, spec), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 64, 130, 1024])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("shape,block_shape", [((336, 520), (48, 40)),
                                               ((384, 640), (128, 128))])
def test_cuda_block_tensor_core_gemm_vs_plain(cuda_device, m, transpose,
                                              shape, block_shape):
    """bf16 block-mode GEMM of more than 8 rows, both orientations; with
    48 x 40 bank tiles one staged tile spans many bank tiles and signs."""
    spec = TH.HashedSpec(virtual_shape=shape, compression=0.125, seed=12,
                         mode="block", block_shape=block_shape)
    x, w = _tc_case(cuda_device, spec, m, transpose, m)
    k, n = (spec.cols, spec.rows) if transpose else (spec.rows, spec.cols)
    plan = THK.gemm_plan(m, k, n, "block", torch.bfloat16,
                         block_cols=block_shape[1])
    ref = THK.hashed_matmul_t_ref if transpose else THK.hashed_matmul_ref
    _check_tc(THK.block_matmul(x, w, spec, transpose=transpose),
              THK.block_matmul(x, w, spec, transpose=transpose),
              ref(x, w, spec), plan)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["element", "block"])
def test_cuda_gemm_bodies_agree_bitwise_repeatable(cuda_device, mode):
    """Both bodies forced at one bf16 shape with split-K (M = 64, K =
    2048): each within one bf16 rounding of the plain version and equal
    to itself across launches."""
    if mode == "element":
        spec = TH.HashedSpec(virtual_shape=(2048, 512), compression=0.125,
                             seed=13, panel_cols=128)
    else:
        spec = TH.HashedSpec(virtual_shape=(2048, 512), compression=0.125,
                             seed=13, mode="block", block_shape=(128, 128))
    x, w = _tc_case(cuda_device, spec, 64, False, 5)
    want = THK.hashed_matmul_ref(x, w, spec)
    for body in ("tensor_core", "cuda_core"):
        plan = THK.gemm_plan(64, 2048, 512, mode, torch.bfloat16,
                             block_cols=128, body=body)
        assert body == "cuda_core" or plan.splits > 1
        fn = THK.element_matmul if mode == "element" else THK.block_matmul
        got, again = fn(x, w, spec, plan=plan), fn(x, w, spec, plan=plan)
        err, scale = _max_err(got, want)
        assert err <= 1e-2 * scale
        assert torch.equal(got, again)


def _gemv_case(cuda_device, m, panel_cols, use_sign, dtype):
    """K x N = 1000 x 650: neither a multiple of the gemv body's 32-row K
    steps nor of its 256-column blocks.  Panels of 256 columns keep every
    block in one panel (the bank slice staged in shared memory); panels
    of 128 and 200 make blocks straddle panels (every value read from
    global memory)."""
    spec = TH.HashedSpec(virtual_shape=(1000, 650), compression=0.125,
                         seed=21, panel_cols=panel_cols, use_sign=use_sign)
    g = torch.Generator(device=cuda_device).manual_seed(m + panel_cols)
    w = torch.randn(spec.num_buckets, generator=g, device=cuda_device) \
        .to(dtype)
    x = torch.randn(m, 1000, generator=g, device=cuda_device).to(dtype)
    return spec, x, w


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16])
@pytest.mark.parametrize("panel_cols", [0, 256, 128, 200])
@pytest.mark.parametrize("use_sign", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gemv_vs_plain_bitwise_repeatable(cuda_device, m, panel_cols,
                                               use_sign, dtype):
    """The gemv body (the element forward at decode size; M = 16 forced)
    with its split-K and with one split: fp32 within 1e-5 x the largest
    plain value (sum order), bf16 within one rounding of the output; the
    same bits on a second launch; counted as a gemv launch."""
    spec, x, w = _gemv_case(cuda_device, m, panel_cols, use_sign, dtype)
    plan = THK.gemm_plan(m, 1000, 650, "element", dtype,
                         body="gemv" if m > 8 else None)
    assert plan.body == "gemv" and plan.splits > 1
    one = dataclasses.replace(plan, splits=1, splitk_bytes=0)
    want = THK.hashed_matmul_ref(x, w, spec)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    before = THK.element_matmul.launches, THK.element_matmul.gemv
    for p in (plan, one):
        got = THK.element_matmul(x, w, spec, plan=p)
        assert got.shape == (m, 650) and got.dtype == dtype
        assert torch.equal(got, THK.element_matmul(x, w, spec, plan=p))
        err, scale = _max_err(got, want)
        assert err <= tol * scale
    assert (THK.element_matmul.launches, THK.element_matmul.gemv) \
        == (before[0] + 4, before[1] + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gemv_one_hot_rows_are_materialized_rows(cuda_device, m,
                                                      dtype):
    """Row m of x one-hot at virtual row r_m: the gemv body returns row
    r_m of V, bitwise (every other product adds an exact zero)."""
    spec, _, w = _gemv_case(cuda_device, m, 256, True, dtype)
    rows = torch.tensor([0, 999, 517, 31, 32, 500, 777, 1][:m],
                        device=cuda_device)
    x = torch.zeros(m, 1000, dtype=dtype, device=cuda_device)
    x[torch.arange(m, device=cuda_device), rows] = 1
    assert THK.gemm_plan(m, 1000, 650, "element", dtype).body == "gemv"
    got = THK.element_matmul(x, w, spec)
    assert torch.equal(got, TH.materialize(w, spec, dtype=dtype)[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("block_shape", [(128, 128), (64, 192)])
def test_cuda_block_dw_vs_plain_and_bitwise_repeatable(cuda_device,
                                                       block_shape):
    spec = TH.HashedSpec(virtual_shape=(768, 1152), compression=0.125,
                         seed=6, mode="block", block_shape=block_shape)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(300, 768, generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    gy = torch.randn(300, 1152, generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    got = THK.block_dw(x, gy, spec)
    assert torch.equal(got, THK.block_dw(x, gy, spec))
    err, scale = _max_err(got, THK.hashed_dw_ref(x, gy, spec))
    assert err <= 1e-5 * scale


def _dw_case(cuda_device, shape, block_shape, m, use_sign=True):
    """A block spec at compression 1/2 whose seed leaves bank tiles no
    virtual tile maps to and chains that mix both signs, and bf16 x, g of
    ``m`` rows."""
    spec = TH.HashedSpec(virtual_shape=shape, compression=0.5, seed=0,
                         mode="block", block_shape=block_shape,
                         use_sign=use_sign)
    g = torch.Generator(device=cuda_device).manual_seed(m)
    x = torch.randn(m, shape[0], generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    gy = torch.randn(m, shape[1], generator=g, device=cuda_device) \
        .to(torch.bfloat16)
    return spec, x, gy


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 300, 1024])
@pytest.mark.parametrize("shape,block_shape", [((768, 1152), (128, 128)),
                                               ((336, 520), (48, 40))])
@pytest.mark.parametrize("use_sign", [True, False])
def test_cuda_block_dw_tensor_core_vs_plain(cuda_device, m, shape,
                                            block_shape, use_sign):
    """bf16 block_dw on the tensor cores (x^T g contracted over M; 300
    rows end inside a 64-row step): 128 x 128 and 48 x 40 bank tiles,
    chains of both signs (or all +1 without signs), bank tiles that no
    virtual tile maps to give exact zeros; within 1e-5 x the largest
    plain value (fp32 sums in another order) and bitwise equal to itself
    across launches."""
    spec, x, gy = _dw_case(cuda_device, shape, block_shape, m, use_sign)
    _, sgn, _, offsets, _ = THK.block_tables(spec, cuda_device)
    empty = offsets[1:] == offsets[:-1]
    assert bool(empty.any())
    assert bool((sgn < 0).any()) == use_sign and bool((sgn > 0).any())
    assert THK.block_dw_plan(m, spec).body == "tensor_core"
    before = THK.block_dw.launches, THK.block_dw.tensor_core
    got = THK.block_dw(x, gy, spec)
    assert (THK.block_dw.launches, THK.block_dw.tensor_core) \
        == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, THK.block_dw(x, gy, spec))
    assert got[empty].abs().max().item() == 0.0
    err, scale = _max_err(got, THK.hashed_dw_ref(x, gy, spec))
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("body,splits", [("tensor_core", 1),
                                         ("tensor_core", 3),
                                         ("tensor_core", 8),
                                         ("cuda_core", 1)])
def test_cuda_block_dw_forced_plans_vs_plain(cuda_device, body, splits):
    """Forced plans at M = 300 on 128 x 128 tiles (chains of 1 to 6
    virtual tiles x 5 row steps): one piece per chain, 3 (uneven
    pieces), 8 (more pieces than the shortest chains have K tiles, so
    some are empty), and the CUDA-core body on bf16; each within 1e-5 x
    scale of the plain version and bitwise repeatable."""
    spec, x, gy = _dw_case(cuda_device, (768, 1152), (128, 128), 300)
    plan = THK.block_dw_plan(300, spec, body=body, splits=splits)
    assert plan.workspace_bytes == (splits * spec.bank_tiles * 128 * 128 * 4
                                    if splits > 1 else 0)
    got = THK.block_dw(x, gy, spec, plan=plan)
    assert torch.equal(got, THK.block_dw(x, gy, spec, plan=plan))
    err, scale = _max_err(got, THK.hashed_dw_ref(x, gy, spec))
    assert err <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["element", "block"])
def test_cuda_autograd_function_vs_cpu(cuda_device, mode):
    """The differentiable entry point on the card (forward, transpose and
    dw kernels) against the CPU plain path, fp32, leading batch dims."""
    if mode == "element":
        spec = TH.HashedSpec(virtual_shape=(256, 384), compression=0.125,
                             seed=2, panel_cols=128)
    else:
        spec = TH.HashedSpec(virtual_shape=(256, 384), compression=0.25,
                             seed=2, mode="block", block_shape=(64, 128))
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal(spec.real_param_shape())
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 45, 256)).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((3, 45, 384))
                           .astype(np.float32))
    grads = []
    for dev in ("cpu", cuda_device):
        tx = x.to(dev).clone().requires_grad_(True)
        tw = w.to(dev).clone().requires_grad_(True)
        y = TOPS.hashed_matmul(tx, tw, spec)
        (y * cot.to(dev)).sum().backward()
        grads.append((y.detach().cpu(), tx.grad.cpu(), tw.grad.cpu()))
    for got, want in zip(grads[1], grads[0]):
        err, scale = _max_err(got, want)
        assert err <= 1e-5 * max(1.0, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
def test_cuda_paged_decode_vs_plain(cuda_device, window):
    g = torch.Generator(device=cuda_device).manual_seed(window)
    pk = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    pv = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    table = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0], [5, 6, 7, 8]],
                         dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([50, 0, 64], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn(3, 4, 128, generator=g, device=cuda_device)
    got = TPA.paged_decode_attention(q, pk, pv, table, lengths, window)
    want = TPA.paged_attention_ref(q, pk, pv, table, lengths, window)
    assert (got - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    assert got[1].abs().max().item() == 0.0


# (dtype, page size, window): bf16 at both page sizes and windows, fp32
# at one
_DECODE_CASES = [(torch.bfloat16, ps, w) for ps in (8, 16) for w in (0, 24)] \
    + [(torch.float32, 16, 24)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,page_size,window", _DECODE_CASES)
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
def test_cuda_paged_decode_split_kv_vs_plain(cuda_device, dtype, page_size,
                                             window, group, head_dim):
    """The split-KV decode over 64-position chunks: lengths at the chunk
    edges (63, 64, 65, 128, 129), one and four chunks, a length-0 row on
    the trash page (exact zeros), rows whose window starts mid-chunk,
    pages in random order; within 1e-2 x scale (bf16, one rounding of
    the output) or 1e-5 x scale (fp32) of the plain version, and bitwise
    equal to itself across launches."""
    n_kv, maxp = 2, 256 // page_size
    g = torch.Generator(device=cuda_device).manual_seed(
        head_dim + group + page_size + window)
    lengths = torch.tensor([0, 1, 24, 63, 64, 65, 129, 256],
                           dtype=torch.int32, device=cuda_device)
    b = lengths.numel()
    npages = b * maxp + 1
    pk = torch.randn(npages, page_size, n_kv, head_dim, generator=g,
                     device=cuda_device).to(dtype)
    pv = torch.randn(npages, page_size, n_kv, head_dim, generator=g,
                     device=cuda_device).to(dtype)
    perm = torch.randperm(npages - 1, generator=g, device=cuda_device) + 1
    table = perm[: b * maxp].reshape(b, maxp).to(torch.int32)
    used = -(-lengths.long() // page_size)
    table[torch.arange(maxp, device=cuda_device)[None, :] >= used[:, None]] = 0
    q = torch.randn(b, n_kv * group, head_dim, generator=g,
                    device=cuda_device).to(dtype)
    before = TPA.paged_decode_attention.launches
    got = TPA.paged_decode_attention(q, pk, pv, table, lengths, window)
    assert TPA.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, TPA.paged_decode_attention(q, pk, pv, table,
                                                       lengths, window))
    assert got[0].abs().max().item() == 0.0
    err, scale = _max_err(got, TPA.paged_attention_ref(q, pk, pv, table,
                                                       lengths, window))
    assert err <= (1e-2 if dtype == torch.bfloat16 else 1e-5) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 20])
def test_cuda_paged_prefill_vs_plain(cuda_device, window):
    g = torch.Generator(device=cuda_device).manual_seed(window)
    pk = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    pv = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    table = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0], [1, 6, 7, 8]],
                         dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([10, 0, 16], dtype=torch.int32, device=cuda_device)
    counts = torch.tensor([40, 0, 23], dtype=torch.int32, device=cuda_device)
    q = torch.randn(3, 40, 4, 128, generator=g, device=cuda_device)
    got = TFP.paged_prefill_attention(q, pk, pv, table, starts, counts,
                                      window)
    want = TFP.paged_prefill_ref(q, pk, pv, table, starts, counts, window)
    assert (got - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    assert got[1].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("head_dim", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 20])
def test_cuda_paged_prefill_tensor_core_vs_plain(cuda_device, group,
                                                 head_dim, window):
    """bf16 prefill on the tensor cores, page size 16: a row starting in
    the middle of a page whose positions span two steps of 64 (32 at
    head_dim 256), a count-0 row, a row with pad slots that shares a
    prefix page, a row from position 0; within 1e-2 x the largest plain
    value (the probabilities are rounded to bf16 for P V) and exact
    zeros in the count-0 row and the pad slots."""
    g = torch.Generator(device=cuda_device).manual_seed(group * head_dim
                                                        + window)
    n_kv, s = 2, 40
    pk = torch.randn(40, 16, n_kv, head_dim, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    pv = torch.randn(40, 16, n_kv, head_dim, generator=g,
                     device=cuda_device).to(torch.bfloat16)
    table = torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8], [0] * 8,
                          [1, 9, 10, 11, 0, 0, 0, 0],
                          [12, 13, 14, 0, 0, 0, 0, 0]],
                         dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([70, 0, 16, 0], dtype=torch.int32,
                          device=cuda_device)
    counts = torch.tensor([40, 0, 23, 33], dtype=torch.int32,
                          device=cuda_device)
    q = torch.randn(4, s, n_kv * group, head_dim, generator=g,
                    device=cuda_device).to(torch.bfloat16)
    before = TFP.paged_prefill_attention.launches
    got = TFP.paged_prefill_attention(q, pk, pv, table, starts, counts,
                                      window)
    assert TFP.paged_prefill_attention.launches == before + 1
    want = TFP.paged_prefill_ref(q, pk, pv, table, starts, counts, window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    err, scale = _max_err(got, want)
    assert err <= 1e-2 * scale
    assert got[1].abs().max().item() == 0.0
    assert got[2, 23:].abs().max().item() == 0.0
    assert got[3, 33:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_topk_mask_vs_plain_bitwise(cuda_device):
    x, k = _topk_case()
    got = TTK.topk_mask(x.to(cuda_device), k.to(cuda_device))
    assert torch.equal(got.cpu(), TTK.topk_mask_ref(x, k))
    bf = x.to(torch.bfloat16)
    got = TTK.topk_mask(bf.to(cuda_device), k.to(cuda_device))
    assert torch.equal(got.cpu(), TTK.topk_mask_ref(bf, k))


def _topk_rows(b, v, dtype, device):
    """b rows of width v: random logits, every third row with 100 ties
    at its threshold, every third with +-0.0 ties; k cycling through the
    disabled and edge values."""
    rng = np.random.default_rng(b + v)
    x = rng.standard_normal((b, v)).astype(np.float32)
    x[1::3, :100] = 3.5
    x[2::3, ::2] = 0.0
    x[2::3, 1::2] = -0.0
    x[2::3, :10] = 1.0
    cycle = [50, 50, 50, 1, v - 1, 0, v, 20, 7, v // 2]
    k = np.array([cycle[r % len(cycle)] for r in range(b)], np.int32)
    return (torch.from_numpy(x).to(device=device, dtype=dtype),
            torch.from_numpy(k).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3, 8, 64])
@pytest.mark.parametrize("v", [1000, 151936, "streaming"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_topk_mask_cluster_vs_plain_bitwise(cuda_device, b, v, dtype):
    """The default plan: rows resident in their cluster's shared memory,
    or, past the width where the slices fit, streamed on every pass;
    bitwise equal to the plain version."""
    stream = v == "streaming"
    if stream:
        v = TTK.streaming_from(TTK.default_plan(b, 1 << 22, dtype), dtype)
    x, k = _topk_rows(b, v, dtype, cuda_device)
    assert TTK.topk_plan(b, v, dtype).resident != stream
    before = TTK.topk_mask.resident
    got = TTK.topk_mask(x, k)
    assert TTK.topk_mask.resident == before + (not stream)
    assert torch.equal(got, TTK.topk_mask_ref(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_topk_mask_forced_plans_vs_plain_bitwise(cuda_device, cluster,
                                                      dtype):
    """Every cluster size at B = 8, V = 151936 (the slices of one CTA a
    row, and of two in fp32, overflow shared memory and stream; more
    hold the row)."""
    x, k = _topk_rows(8, 151936, dtype, cuda_device)
    plan = TTK.topk_plan(8, 151936, dtype, cluster=cluster)
    assert plan.resident == (cluster >= (4 if dtype == torch.float32
                                         else 2))
    got = TTK.topk_mask(x, k, plan=plan)
    assert torch.equal(got, TTK.topk_mask_ref(x, k))


@pytest.mark.cuda
def test_cuda_engine_greedy_tokens_match_cpu_plain_path(cuda_device):
    """The whole serving path on the card (every kernel) against the
    CPU plain path, fp32, small model with head_dim 64 (the attention
    kernels compile head_dim 64/128/256): identical greedy tokens with
    prefix caching and chunked, batched prefill."""
    import repro_torch.configs as C
    from repro_torch import kernels as K
    from repro_torch.models import build
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = C.reduced(C.get("qwen3-1.7b")).hashed_variant(0.125).with_(
        dtype="float32", head_dim=64, hash_panel_cols=32)
    cpu_model = build(cfg, device="cpu")
    params = cpu_model.init(0)
    rng = np.random.default_rng(0)
    shared = rng.integers(2, cfg.vocab_size, size=20)
    prompts = [np.concatenate([shared, rng.integers(2, cfg.vocab_size,
                                                    size=n)])
               for n in (3, 9, 17, 1, 30)]

    def run(device, model, p):
        eng = Engine(model, p, device=device, max_concurrency=3, max_len=64,
                     eos_id=-1, page_size=8, prefix_cache=True,
                     prefill_chunk=16,
                     scheduler=SchedulerConfig(max_queue=8,
                                               max_prefills_per_tick=3))
        for uid, pr in enumerate(prompts):
            assert eng.submit(Request(uid=uid, prompt=pr.astype(np.int32),
                                      max_new_tokens=6))
        eng.run()
        eng.kv.leak_check()
        return {r.uid: r.tokens for r in eng._done}

    want = run("cpu", cpu_model, params)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(cuda_device)
    gpu_params = to_dev(params)
    K.reset_counts()
    got = run("cuda", build(cfg, device="cuda"), gpu_params)
    counts = K.counts()
    assert got == want
    assert all(c["launches"] > 0 for c in
               (counts["hashed_matmul"], counts["paged_decode"],
                counts["paged_prefill"]))
    assert all(c["plain_cuda_calls"] == 0 for c in counts.values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["element", "block"])
def test_cuda_train_step_matches_cpu_plain_path(cuda_device, mode):
    """One gradient evaluation and one AdamW step of a small fp32 model on
    the card (forward, transpose and dw kernels, block tiles of 32 x 32)
    against the CPU plain path: loss within 1e-5 relative, every gradient
    within 1e-4 x max(1, largest CPU value) (fp32 sums in another order
    through 2 layers, forward and back)."""
    import repro_torch.configs as C
    from repro_torch import kernels as K
    from repro_torch import policy
    from repro_torch.models import build
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    base = C.reduced(C.get("qwen3-1.7b")).with_(dtype="float32")
    if mode == "element":
        cfg = base.hashed_variant(0.125).with_(hash_panel_cols=32)
        kernels = ("hashed_matmul", "hashed_matmul_t", "hashed_dw")
    else:
        cfg = base.policy_variant(policy.CompressionPolicy(
            mode="block", block_shape=(32, 32), path="pallas"))
        kernels = ("block_matmul", "block_dw")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 24)))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    params = build(cfg, device="cpu").init(0)
    out = {}
    for dev in ("cpu", cuda_device):
        model = build(cfg, device=dev)
        p = opt_lib.tree_map(lambda t: t.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        leaves = [t.detach().requires_grad_(True)
                  for t in opt_lib.tree_leaves(p)]
        loss, _ = model.train_loss(opt_lib.tree_unflatten(p, leaves), b)
        grads = torch.autograd.grad(loss, leaves)
        opt = opt_lib.adamw(opt_lib.constant_lr(1e-3))
        K.reset_counts()
        state, metrics = step_lib.make_train_step(model, opt)(
            {"params": p, "opt": opt.init(p),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}, b)
        out[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads],
                         float(metrics["loss"]), K.counts())
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    assert abs(gpu[0] - cpu[0]) <= 1e-5 * abs(cpu[0])
    assert abs(gpu[2] - cpu[2]) <= 1e-5 * abs(cpu[2])
    for g_gpu, g_cpu in zip(gpu[1], cpu[1]):
        err, scale = _max_err(g_gpu, g_cpu)
        assert err <= 1e-4 * max(1.0, scale)
    assert all(gpu[3][k]["launches"] > 0 for k in kernels)
    assert all(c["plain_cuda_calls"] == 0 for c in gpu[3].values())


@pytest.mark.cuda
@pytest.mark.parametrize("b,k", [(4, 3), (2, 7), (4, 5)])
def test_cuda_verify_block_logits_bitwise_decode_steps(cuda_device, b, k):
    """On a small bf16 model on the card (head_dim 64: the attention
    kernels compile 64/128/256), the verify block's logits (B rows of k+1
    slots, the default forms) are bitwise k+1 successive decode steps',
    and so are the K/V it writes.  At B*(k+1) <= 16 the projections run
    fused on the gemv body; above, per slot."""
    import repro_torch.configs as C
    from repro_torch import kernels as K
    from repro_torch.models import build

    cfg = C.reduced(C.get("qwen3-1.7b")).hashed_variant(0.125).with_(
        head_dim=64, hash_panel_cols=32)
    model = build(cfg, device="cuda")
    params = model.init(0)
    rng = np.random.default_rng(5)
    ps, maxp = 8, 8
    pages = model.init_paged_cache(b * maxp + 1, ps)
    table = torch.arange(1, b * maxp + 1, dtype=torch.int32,
                         device="cuda").reshape(b, maxp)
    lens = rng.integers(3, 30, b)
    toks = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                         (b, int(lens.max())))).cuda()
    lengths = torch.from_numpy(lens.astype(np.int32)).cuda()
    zeros = torch.zeros(b, dtype=torch.int32, device="cuda")
    model.prefill_paged(params, toks, pages, table, zeros, lengths, zeros)
    s_blk = k + 1
    blk = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                        (b, s_blk))).cuda()
    counts = torch.full((b,), s_blk, dtype=torch.int32, device="cuda")
    pages_b = {n: v.clone() for n, v in pages.items()}
    forms = model.block_forms(b, s_blk)
    assert forms["norm"] == forms["head"] == "slot"
    assert (forms["qkv"] == "fused") == (b * s_blk <= 16)
    K.reset_counts()
    got = model.decode_paged_block(params, blk, pages_b, table, lengths,
                                   counts)
    assert K.counts()["paged_decode"]["launches"] == \
        cfg.num_layers * s_blk
    for s in range(s_blk):
        step = model.decode_paged(params, blk[:, s:s + 1], pages, table,
                                  lengths + s)
        assert torch.equal(got[:, s], step[:, 0]), s
    for n in ("k", "v"):
        assert torch.equal(pages_b[n], pages[n])
    assert all(c["plain_cuda_calls"] == 0 for c in K.counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cuda_artifact_loads_saved_bits(cuda_device, tmp_path, quant):
    """An artifact exported from the card and loaded back onto it holds the
    saved bits (bf16 leaves included); an int8 one holds the host
    dequantization's bits."""
    import repro_torch.configs as C
    from repro_torch import artifact
    from repro_torch.artifact import format as F
    from repro_torch.models import build

    cfg = C.reduced(C.get("qwen3-1.7b")).hashed_variant(0.125)
    params = build(cfg, device="cuda").init(0)
    path = str(tmp_path / "m.hnart")
    artifact.export_model(path, cfg, params, quant=quant,
                          quant_min_size=256)
    _, _, loaded = artifact.load_model(path, device="cuda")
    _, host = artifact.load(path, device="cpu")
    for (p, a), (_, b), (_, h) in zip(F.flatten_with_paths(params),
                                      F.flatten_with_paths(loaded),
                                      F.flatten_with_paths(host)):
        assert b.is_cuda and b.dtype == a.dtype, p
        assert torch.equal(b.cpu(), h), p
        if quant == "none":
            assert torch.equal(a, b), p
