"""Fused decompress-GEMM kernels of HashedNets and their gradients.

Kernels (CUDA C++, sm_90a), one wrapper each, replacing the JAX
package's ``kernels/hashed_matmul.py``:

- :func:`element_matmul` — ``y = x @ V``, element mode
  (``csrc/hashed_matmul.cu``; ``element_matmul(transpose=False)``);
- :func:`element_matmul_t` — ``dx = g @ V^T``, the same kernels with the
  virtual coordinates swapped (``element_matmul(transpose=True)``);
- :func:`element_dw` — the bank gradient of paper Eq. 12
  (``csrc/hashed_dw.cu`` + ``tile_gemm.cuh``; ``element_dw``);
- :func:`block_matmul` — ``x @ V`` or ``x @ V^T`` in block mode
  (``csrc/hashed_block.cu``; ``block_matmul``);
- :func:`block_dw` — the block-mode bank gradient (same source;
  ``block_dw``).

The three GEMMs run one of three bodies, chosen by :func:`gemm_plan`
from (M, K, N, mode, dtype, orientation):

- **gemv** (``csrc/hashed_matmul.cu`` ``hashed_gemv``) for the element
  forward of at most ``GEMV_MAX_ROWS`` = 16 rows (bf16 or fp32;
  serving's decode steps): each thread hashes a few rows of its
  own columns, gathers those bank values with many loads in flight and
  adds ``x[m][i] * V[i][j]`` straight into registers for each of the M
  rows (M a template parameter), with no V tile in shared memory and
  no barrier per K step.  One block of 256 columns per SM, holding as
  much of its panel's bucket slice in shared memory as fits (all but
  the last 14 % of qwen3-1.7b's 256 KB slices, under a third of
  ``ffn.out``'s 768 KB), the rest read through L1 and L2.  What bounds
  it: the hashing (two murmur mixes, the bucket reduction and the sign
  of every virtual weight: 34 instructions a weight at M = 8 by the
  hash's definition, ~38 in the kernel's SASS) and,
  where the slice does not fit, the random bank reads from L2; not
  bytes.
- **tensor cores** for the other bf16 products of ``TC_MIN_ROWS`` = 9
  rows or more (training steps, prefill): 128 x 128 output tiles,
  ``wgmma`` on bf16 operands with fp32 sums — what the TPU kernels do,
  which cast each decompressed tile to x's dtype and multiply with
  ``preferred_element_type=float32`` — fed by a 4-slot ``cp.async``
  ring.  V is first decompressed once per call into a bf16 workspace
  (``R * C * 2`` bytes, 25.2 MB at qwen3-1.7b's ``ffn.out``, released
  after the call): element mode hashes each virtual weight once there
  and not once per row block, block mode copies bank tiles with their
  signs.  Element mode is bound by the decompression's random L2
  gathers (over half its time at every M), block mode by the GEMM's
  operand traffic from L2.
- **CUDA cores** (``csrc/tile_gemm.cuh`` ``decompress_gemm``) for the
  other fp32 products, which keep full fp32 products (no TF32), and at
  decode size (M <= 8) for the element transpose and block mode: each
  block
  decompresses 32 x 64 tiles of V into shared memory and reuses them for
  all its rows.

Every element-mode body reduces the hash to a bucket by a multiply-high
with a per-spec constant and one conditional subtraction
(:func:`bucket_magic`), exactly ``h % Kp``.

Split-K over an fp32 workspace (reduced in split order) keeps enough
blocks in flight when M or N is small.  Same inputs, same bits: no float
atomics anywhere.  Both ``dw`` kernels sum each bucket or bank tile in a
fixed order over a static map of the virtual positions that hash to it,
built once per spec on the device and cached here.

``block_dw`` and ``element_dw`` run one of two bodies for ``x^T g`` too,
chosen by :func:`block_dw_plan` and :func:`element_dw_plan`: bf16 takes
the tensor cores (``wgmma``, bf16 operands, fp32 sums, as the TPU
kernels' dots with ``preferred_element_type=float32``), each bank tile's
chain of virtual tiles cut into a fixed number of pieces whose fp32
partials are added in order (element mode: one R x C "bank tile" whose
chain is one virtual tile, pieces over M only); fp32 keeps the CUDA-core
body.

The plain versions are the ports of the JAX package's ``kernels/ref.py``
oracles (``hashed_matmul_ref``, ``hashed_matmul_t_ref``,
``hashed_dw_ref``): they materialize V in fp32 and take either mode.
The CPU path takes them; on a CUDA tensor each wrapper launches its
kernel or raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import hashed as H
from repro_torch.kernels import _build

_SMS = 132          # H100 SXM streaming multiprocessors
# The element forward of at most GEMV_MAX_ROWS rows (its largest row
# block, a template) takes the gemv body, which the hashing bounds; other
# bf16 products of at least TC_MIN_ROWS rows take the tensor cores.
# chip_smoke phase 3 times the bodies at M = 1 to 1024 on the H100
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md): at M = 16 the gemv body still
# beats the tensor cores (attn.q 0.0239 vs 0.0394 ms, ffn.out 0.0941 vs
# 0.1083 ms); the CUDA-core body loses to them from M = 16 on (attn.q
# 0.0612 vs 0.0394 ms)
GEMV_MAX_ROWS = 16
TC_MIN_ROWS = 9
GEMV_COLS = 256     # gemv: output columns a block (csrc GV_BN) ...
GEMV_KSTEP = 32     # ... and the K granularity of a split (csrc GV_KSTEP)
_BODY_CODE = {"cuda_core": 0, "tensor_core": 1, "gemv": 2}


def bucket_magic(kp: int) -> int:
    """The constant of ``rt::bucket_mod`` (``csrc/common.cuh``) for ``kp``
    buckets a panel: floor((2**32 - 1) / kp), so that for every uint32 h,
    with q = (h * magic) >> 32 and r = h - q * kp (mod 2**32),
    ``h % kp == min(r, (r - kp) % 2**32)``."""
    if not 1 <= kp < 2 ** 32:
        raise ValueError(f"buckets per panel {kp} outside [1, 2**32)")
    return (2 ** 32 - 1) // kp


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def hashed_matmul_ref(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec,
                      dtype=None) -> torch.Tensor:
    """y = x @ V with V materialized in fp32 (the plain version)."""
    if x.is_cuda:
        hashed_matmul_ref.cuda_calls += 1
    dtype = dtype or x.dtype
    v = H.materialize(w, spec, dtype=torch.float32)
    return (x.float() @ v).to(dtype)


def hashed_matmul_t_ref(g: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec,
                        dtype=None) -> torch.Tensor:
    """dx = g @ V^T with V materialized in fp32 (the plain version)."""
    if g.is_cuda:
        hashed_matmul_t_ref.cuda_calls += 1
    dtype = dtype or g.dtype
    v = H.materialize(w, spec, dtype=torch.float32)
    return (g.float() @ v.t()).to(dtype)


def hashed_dw_ref(x: torch.Tensor, g: torch.Tensor, spec: H.HashedSpec,
                  dtype=torch.float32) -> torch.Tensor:
    """Bank gradient given the upstream grad g of y = x @ V (paper Eq. 12).

    element: dw[k] = sum_{(i,j): h(i,j)=k} xi(i,j) * (x^T g)[i, j]
    block:   dbank[b] = sum_{(ti,tj): h=b} sigma(ti,tj) * (x^T g)[tile ti,tj]
    """
    if x.is_cuda:
        hashed_dw_ref.cuda_calls += 1
    gv = x.reshape(-1, x.shape[-1]).float().t() \
        @ g.reshape(-1, g.shape[-1]).float()
    if spec.mode == "element":
        i = torch.arange(spec.rows, dtype=torch.int64, device=x.device)[:, None]
        j = torch.arange(spec.cols, dtype=torch.int64, device=x.device)[None, :]
        idx, sgn = H.element_indices(spec, i, j)
        out = torch.zeros(spec.num_buckets, dtype=torch.float32,
                          device=x.device)
        out.index_add_(0, idx.reshape(-1), (gv * sgn.float()).reshape(-1))
        return out.to(dtype)
    bm, bn = spec.block_shape
    gi, gj = spec.tile_grid
    idx, sgn = H.block_indices(spec, x.device)
    rpad, cpad = gi * bm - spec.rows, gj * bn - spec.cols
    if rpad or cpad:
        # ragged tile grid: the cotangent is zero over the padded region
        gv = F.pad(gv, (0, cpad, 0, rpad))
    tiles = gv.reshape(gi, bm, gj, bn).permute(0, 2, 1, 3)  # (gi,gj,bm,bn)
    tiles = tiles * sgn[..., None, None].float()
    out = torch.zeros((spec.bank_tiles, bm, bn), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, idx.reshape(-1), tiles.reshape(-1, bm, bn))
    return out.to(dtype)


for _plain in (hashed_matmul_ref, hashed_matmul_t_ref, hashed_dw_ref):
    _plain.cuda_calls = 0


# ---------------------------------------------------------------------------
# static index maps, built once per spec on the device
# ---------------------------------------------------------------------------

_MAPS: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def _segments(keys: torch.Tensor, n: int):
    """(order, offsets), both int32: positions of ``keys`` grouped by key
    (a stable sort, so ascending position inside each group) and each
    group's start, with ``offsets[n]`` = len(keys)."""
    order = torch.argsort(keys, stable=True).to(torch.int32)
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=keys.device)
    offsets[1:] = torch.cumsum(torch.bincount(keys, minlength=n), 0)
    return order, offsets


def element_segments(spec: H.HashedSpec, device):
    """Inverse hash map of an element-mode spec: (order, offsets), every
    virtual position i * cols + j grouped by bucket (ascending inside
    each bucket), with bit 31 of its int32 entry set where the sign
    xi(i, j) is -1 (``element_dw``'s segment pass applies it).  4 bytes
    per virtual weight (plus the bucket offsets), built on ``device`` and
    cached for the process."""
    key = ("element", spec, str(device))
    if key not in _MAPS:
        if spec.virtual_size >= 2 ** 31:
            raise ValueError(f"element_dw: {spec.virtual_shape} has more "
                             f"than 2**31 virtual positions")
        i = torch.arange(spec.rows, dtype=torch.int64, device=device)[:, None]
        j = torch.arange(spec.cols, dtype=torch.int64, device=device)[None, :]
        idx, sgn = H.element_indices(spec, i, j)
        order, offsets = _segments(idx.reshape(-1), spec.num_buckets)
        pos = order.long()
        # p - 2**31 is p with bit 31 set, in int32
        pos = torch.where(sgn.reshape(-1)[pos] < 0, pos - 2 ** 31, pos)
        _MAPS[key] = (pos.to(torch.int32), offsets)
    return _MAPS[key]


def block_tables(spec: H.HashedSpec, device):
    """(idx, sgn, order, offsets, heavy), int32 on ``device``, cached: the
    row-major (gi, gj) tile -> bank map and tile signs, the virtual tiles
    grouped by bank tile in the JAX kernel's stable-argsort order, and
    the bank tiles by descending chain length (``block_dw`` launches the
    longest chains first)."""
    key = ("block", spec, str(device))
    if key not in _MAPS:
        idx, sgn = H.block_indices(spec, device)
        idx = idx.reshape(-1)
        order, offsets = _segments(idx, spec.bank_tiles)
        heavy = torch.argsort(offsets[1:] - offsets[:-1], descending=True,
                              stable=True).to(torch.int32)
        _MAPS[key] = (idx.to(torch.int32), sgn.reshape(-1).to(torch.int32),
                      order, offsets, heavy)
    return _MAPS[key]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GemmPlan:
    """How one hashed GEMM runs: ``body`` ("tensor_core", "cuda_core" or
    "gemv"), its output tile (``bm`` x ``bn``; gemv: ``bm`` the row
    block the kernel is compiled for), contraction tile ``bk`` (gemv: the
    K granularity of a split), split-K factor, and the transient
    workspaces the wrapper allocates for the call: ``v_bytes`` for V
    decompressed in bf16 (the tensor-core body, either mode) and
    ``splitk_bytes`` for the fp32 partials (splits > 1)."""
    body: str
    bm: int
    bn: int
    bk: int
    splits: int
    v_bytes: int
    splitk_bytes: int

    @property
    def workspace_bytes(self) -> int:
        return self.v_bytes + self.splitk_bytes


_TILES = {"tensor_core": (128, 128, 64), "cuda_core": (64, 64, 32)}


def tensor_core_ok(m: int, k: int, n: int, dtype,
                   block_cols: int = 0) -> bool:
    """Whether the tensor-core body takes this product: bf16, K and N in
    whole 16-byte chunks, and (block mode) bank tiles whose rows hold
    whole chunks."""
    return (dtype == torch.bfloat16 and m > 0 and k % 8 == 0 and n % 8 == 0
            and block_cols % 8 == 0)


def gemv_ok(m: int, mode: str, transpose: bool) -> bool:
    """Whether the gemv body takes this product: the element forward of
    1 to ``GEMV_MAX_ROWS`` rows, in either dtype."""
    return mode == "element" and not transpose and 0 < m <= GEMV_MAX_ROWS


def _gemv_plan(m: int, k: int, n: int) -> GemmPlan:
    """The gemv body's plan: the row block is m rounded up to a power of
    two; K splits as many as keep its blocks within one wave, counted as
    the kernel launches them (it rounds a split up to whole K steps,
    ``rt::split_k``)."""
    want = max(1, _SMS // -(-n // GEMV_COLS))
    per = -(-(-(-k // want)) // GEMV_KSTEP) * GEMV_KSTEP
    splits = -(-k // per)
    return GemmPlan("gemv", 1 << (m - 1).bit_length(), GEMV_COLS,
                    GEMV_KSTEP, splits, 0,
                    splits * m * n * 4 if splits > 1 else 0)


def gemm_plan(m: int, k: int, n: int, mode: str = "element",
              dtype=torch.bfloat16, *, block_cols: int = 0,
              transpose: bool = False,
              body: Optional[str] = None) -> GemmPlan:
    """The plan of a (m, k) @ (k, n) hashed GEMM in ``mode`` ("element" or
    "block", whose bank tiles have ``block_cols`` columns); ``transpose``
    for the ``g @ V^T`` orientation.  ``body`` forces a body (chip_smoke
    times them); by default the element forward of at most
    ``GEMV_MAX_ROWS`` rows takes the gemv body, other bf16 products of
    ``TC_MIN_ROWS`` rows or more the tensor cores, the rest the CUDA
    cores.  Split-K: the gemv body takes as many
    splits as keep its (256-column, split) blocks within one wave over
    the card's SMs (one block an SM), each split at least 32 rows; the
    CUDA-core body doubles the splits until its (column, row, split)
    blocks make two waves; the tensor-core body doubles them while the
    doubled count still fits one wave (one block per SM), since each
    split adds an fp32 partial of M x N to write and reduce.  No split is
    shorter than one K tile (four on the tensor cores)."""
    if mode not in ("element", "block"):
        raise ValueError(f"mode {mode!r}")
    tc = tensor_core_ok(m, k, n, dtype, block_cols)
    if body is None:
        if gemv_ok(m, mode, transpose):
            body = "gemv"
        elif tc and m >= TC_MIN_ROWS:
            body = "tensor_core"
        else:
            body = "cuda_core"
    elif body == "tensor_core" and not tc:
        raise ValueError(f"the tensor-core body takes bf16 with K, N and "
                         f"bank tile columns multiples of 8; got m={m} "
                         f"k={k} n={n} {dtype} block_cols={block_cols}")
    elif body == "gemv" and not gemv_ok(m, mode, transpose):
        raise ValueError(f"the gemv body takes the element forward of 1 "
                         f"to {GEMV_MAX_ROWS} rows; got m={m} {mode} "
                         f"transpose={transpose}")
    elif body not in _BODY_CODE:
        raise ValueError(f"body {body!r}")
    if body == "gemv":
        return _gemv_plan(m, k, n)
    bm, bn, bk = _TILES[body]
    if body == "cuda_core" and m <= 8:
        bm = 8
    blocks = -(-n // bn) * -(-m // bm)
    splits = 1
    if body == "tensor_core":
        while 2 * blocks * splits <= _SMS and splits * 2 * bk * 4 <= k:
            splits *= 2
    else:
        while blocks * splits < 2 * _SMS and splits * 2 * bk <= k:
            splits *= 2
    v_bytes = k * n * 2 if body == "tensor_core" else 0
    return GemmPlan(body, bm, bn, bk, splits, v_bytes,
                    splits * m * n * 4 if splits > 1 else 0)


def _check(what: str, x: torch.Tensor, k: int) -> None:
    _build.require_cuda(x, what)
    if x.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not supported")
    if x.dim() != 2 or x.shape[1] != k or not x.is_contiguous():
        raise ValueError(f"{what}: x {tuple(x.shape)} is not a contiguous "
                         f"matrix of {k} columns")


def _bank(what: str, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    w = w.to(x.dtype)
    if not w.is_contiguous() or w.device != x.device:
        raise ValueError(f"{what}: the bank must be contiguous and on "
                         f"{x.device}")
    return w


def _grad_rows(what: str, x: torch.Tensor, g: torch.Tensor,
               k: int) -> torch.Tensor:
    g = g.to(x.dtype)
    _check(what, g, k)
    if g.shape[0] != x.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} differ in rows")
    return g


def _gemm_out(x: torch.Tensor, n: int, plan: GemmPlan):
    """Output, split-K workspace and V workspace of a (M, K) @ (K, n)
    kernel GEMM run by ``plan``, sized from the operands (a plan may have
    been made for another shape)."""
    m, k = x.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    ws = torch.empty((plan.splits, m, n), dtype=torch.float32,
                     device=x.device) if plan.splits > 1 else None
    vws = torch.empty(k * n, dtype=torch.bfloat16, device=x.device) \
        if plan.body == "tensor_core" else None
    return y, ws, vws


def _element_gemm(x, w, spec, transpose: bool,
                  plan: Optional[GemmPlan] = None):
    """Launch one element-mode GEMM; returns (y, the plan it ran)."""
    what = "element_matmul_t" if transpose else "element_matmul"
    if spec.mode != "element":
        raise ValueError(f"{what} takes element-mode specs")
    k, n = (spec.cols, spec.rows) if transpose else (spec.rows, spec.cols)
    _check(what, x, k)
    w = _bank(what, w, x)
    if w.numel() != spec.num_buckets:
        raise ValueError(f"bank has {w.numel()} values, spec wants "
                         f"{spec.num_buckets}")
    kp = spec.buckets_per_panel
    plan = plan or gemm_plan(x.shape[0], k, n, "element", x.dtype,
                             transpose=transpose)
    if plan.body == "tensor_core":
        x = _build.aligned16(x)
    y, ws, vws = _gemm_out(x, n, plan)
    fn = _build.bind("hashed_matmul", "hashed_element_matmul",
                     [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                     + [ctypes.c_uint, ctypes.c_uint, ctypes.c_int,
                        ctypes.c_uint]
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(y), _build.ptr(vws),
            _build.ptr(ws), x.shape[0], k, n, kp, bucket_magic(kp),
            spec.panel_cols, spec.seed & 0xFFFFFFFF, int(spec.use_sign),
            _build.DTYPE_CODE[x.dtype], _BODY_CODE[plan.body], plan.bm,
            plan.splits, int(transpose), _build.stream_of(x))
    _build.check(rc, what)
    return y, plan


def element_matmul(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                   out_dtype=None,
                   plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """x (M, R) @ V -> (M, C), element mode; ``plan`` (default
    :func:`gemm_plan`) picks the body.  Besides ``launches``,
    ``element_matmul`` counts the launches of each body (``gemv``,
    ``tensor_core``) and those of at most ``GEMV_MAX_ROWS`` rows
    (``small``)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return hashed_matmul_ref(x, w, spec, out_dtype)
    y, plan = _element_gemm(x, w, spec, transpose=False, plan=plan)
    element_matmul.launches += 1
    element_matmul.gemv += plan.body == "gemv"
    element_matmul.tensor_core += plan.body == "tensor_core"
    element_matmul.small += x.shape[0] <= GEMV_MAX_ROWS
    return y if out_dtype == x.dtype else y.to(out_dtype)


def element_matmul_t(g: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                     out_dtype=None,
                     plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """g (M, C) @ V^T -> (M, R), element mode (the input gradient);
    ``plan`` as in :func:`element_matmul`."""
    out_dtype = out_dtype or g.dtype
    if g.device.type == "cpu":
        return hashed_matmul_t_ref(g, w, spec, out_dtype)
    y, _ = _element_gemm(g, w, spec, transpose=True, plan=plan)
    element_matmul_t.launches += 1
    return y if out_dtype == g.dtype else y.to(out_dtype)


def element_dw(x: torch.Tensor, g: torch.Tensor, spec: H.HashedSpec, *,
               plan: Optional[DwPlan] = None) -> torch.Tensor:
    """dw (num_buckets,) fp32 from x (M, R) and the upstream grad g (M, C)
    of y = x @ V, element mode; ``plan`` (default :func:`element_dw_plan`)
    picks the body of the product ``x^T g`` and its pieces over M.
    ``element_dw.tensor_core`` counts the launches on the tensor cores."""
    if x.device.type == "cpu":
        return hashed_dw_ref(x, g, spec)
    if spec.mode != "element":
        raise ValueError("element_dw takes element-mode specs")
    _check("element_dw", x, spec.rows)
    g = _grad_rows("element_dw", x, g, spec.cols)
    order, offsets = element_segments(spec, x.device)
    plan = plan or element_dw_plan(x.shape[0], spec, x.dtype)
    tc = plan.body == "tensor_core"
    if tc:
        x, g = _build.aligned16(x), _build.aligned16(g)
    ws = torch.empty(spec.virtual_size, dtype=torch.float32, device=x.device)
    split_ws = torch.empty((plan.splits, spec.virtual_size),
                           dtype=torch.float32, device=x.device) \
        if tc and plan.splits > 1 else None
    dw = torch.empty(spec.num_buckets, dtype=torch.float32, device=x.device)
    fn = _build.bind("hashed_dw", "hashed_element_dw",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(g), _build.ptr(ws),
            _build.ptr(split_ws), _build.ptr(order), _build.ptr(offsets),
            _build.ptr(dw), x.shape[0], spec.rows, spec.cols,
            spec.num_buckets, _build.DTYPE_CODE[x.dtype], int(tc),
            plan.splits, _build.stream_of(x))
    _build.check(rc, "element_dw")
    element_dw.launches += 1
    element_dw.tensor_core += int(tc)
    return dw


def _check_block_grid(what: str, spec: H.HashedSpec):
    if spec.mode != "block":
        raise ValueError(f"{what} takes block-mode specs")
    brow, bcol = spec.block_shape
    if spec.rows % brow or spec.cols % bcol:
        raise ValueError(f"{what} needs block_shape {spec.block_shape} to "
                         f"divide virtual_shape {spec.virtual_shape}")


def block_matmul(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                 transpose: bool = False, out_dtype=None,
                 plan: Optional[GemmPlan] = None) -> torch.Tensor:
    """x (M, R) @ V -> (M, C), or with ``transpose`` g (M, C) @ V^T ->
    (M, R), block mode; w is the bank (bank_tiles, brow, bcol).
    ``plan`` (default :func:`gemm_plan`) picks the body.
    ``block_matmul.transposed`` counts the launches of the second kind."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        ref = hashed_matmul_t_ref if transpose else hashed_matmul_ref
        return ref(x, w, spec, out_dtype)
    _check_block_grid("block_matmul", spec)
    k, n = (spec.cols, spec.rows) if transpose else (spec.rows, spec.cols)
    _check("block_matmul", x, k)
    w = _bank("block_matmul", w, x)
    if tuple(w.shape) != spec.real_param_shape():
        raise ValueError(f"bank {tuple(w.shape)}, spec wants "
                         f"{spec.real_param_shape()}")
    idx, sgn, *_ = block_tables(spec, x.device)
    brow, bcol = spec.block_shape
    plan = plan or gemm_plan(x.shape[0], k, n, "block", x.dtype,
                             block_cols=bcol, transpose=transpose)
    if plan.body == "tensor_core":
        x, w = _build.aligned16(x), _build.aligned16(w)
    y, ws, vws = _gemm_out(x, n, plan)
    fn = _build.bind("hashed_block", "hashed_block_matmul",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(idx), _build.ptr(sgn),
            _build.ptr(y), _build.ptr(vws), _build.ptr(ws), x.shape[0], k, n,
            brow, bcol,
            spec.tile_grid[1], _build.DTYPE_CODE[x.dtype], plan.bm,
            plan.splits, int(transpose), _build.stream_of(x))
    _build.check(rc, "block_matmul")
    block_matmul.launches += 1
    block_matmul.transposed += int(transpose)
    return y if out_dtype == x.dtype else y.to(out_dtype)


@dataclass(frozen=True)
class DwPlan:
    """How one ``block_dw`` or ``element_dw`` runs: ``body``
    ("tensor_core" or "cuda_core") of the product ``x^T g``, the number
    of pieces (``splits``) each bank tile's chain of (virtual tile, 64-row
    step of M) products is cut into, and the fp32 partials' workspace
    (``splits x bank_tiles x brow x bcol x 4`` bytes when ``splits > 1``)
    the wrapper allocates for the call.  Element mode is one bank tile of
    R x C whose chain is one virtual tile; its R x C x 4 bytes of product,
    which every body writes, are not counted here."""
    body: str
    splits: int
    workspace_bytes: int


DW_TILE = 128       # tensor-core block_dw: output tile edge ...
DW_STEP = 64        # ... and rows of M per K tile
DW_WAVES = 4        # at most this many waves of blocks over the SMs ...
DW_MIN_STEPS = 16   # ... and no piece under this many K tiles on average


def block_dw_ok(m: int, block_shape, dtype) -> bool:
    """Whether the tensor-core ``x^T g`` takes this product: bf16, and
    bank tiles (element mode: the whole R x C) whose rows and columns
    hold whole 16-byte chunks."""
    brow, bcol = block_shape
    return dtype == torch.bfloat16 and m > 0 and brow % 8 == 0 \
        and bcol % 8 == 0


def _dw_plan(what: str, m: int, bank_tiles: int, block_shape,
             virtual_tiles: int, dtype, body: Optional[str],
             splits: Optional[int]) -> DwPlan:
    tc = block_dw_ok(m, block_shape, dtype)
    if body is None:
        body = "tensor_core" if tc else "cuda_core"
    elif body == "tensor_core" and not tc:
        raise ValueError(f"the tensor-core {what} takes bf16 with bank "
                         f"tile rows and columns multiples of 8; got m={m} "
                         f"{dtype} block_shape={tuple(block_shape)}")
    elif body not in _TILES:
        raise ValueError(f"body {body!r}")
    if body == "cuda_core":
        if splits not in (None, 1):
            raise ValueError(f"the CUDA-core {what} does not split")
        return DwPlan(body, 1, 0)
    brow, bcol = block_shape
    blocks = bank_tiles * -(-brow // DW_TILE) * -(-bcol // DW_TILE)
    mean_steps = virtual_tiles * -(-m // DW_STEP) / bank_tiles
    if splits is None:
        splits = 1
        while blocks * splits * 2 <= DW_WAVES * _SMS \
                and mean_steps / (splits * 2) >= DW_MIN_STEPS:
            splits *= 2
    elif splits < 1:
        raise ValueError(f"splits {splits}")
    return DwPlan(body, splits, splits * bank_tiles * brow * bcol * 4
                  if splits > 1 else 0)


def block_dw_plan(m: int, spec: H.HashedSpec, dtype=torch.bfloat16, *,
                  body: Optional[str] = None,
                  splits: Optional[int] = None) -> DwPlan:
    """The plan of ``block_dw`` on x (m, rows) and g (m, cols) of a
    block-mode ``spec``.  ``body`` and ``splits`` force a choice
    (chip_smoke times them); by default bf16 takes the tensor cores when
    :func:`block_dw_ok`, and the splits double while the (bank tile,
    piece, 128 x 128 output tile) blocks stay within ``DW_WAVES`` waves
    over the card's SMs and a piece keeps at least ``DW_MIN_STEPS`` K
    tiles of the mean chain (virtual tiles per bank tile x 64-row steps
    of M): the chains differ in length, so the longest run first and
    more, shorter pieces even the waves out, while every piece adds a
    pipeline fill and an fp32 partial of its tile to write and reduce.
    Both limits come from H100 timings of 1 to 16 splits at qwen3-1.7b's
    ``attn.q``, ``attn.k`` and ``ffn.out`` (PERF.md)."""
    if spec.mode != "block":
        raise ValueError("block_dw_plan takes block-mode specs")
    gi, gj = spec.tile_grid
    return _dw_plan("block_dw", m, spec.bank_tiles, spec.block_shape,
                    gi * gj, dtype, body, splits)


def element_dw_plan(m: int, spec: H.HashedSpec, dtype=torch.bfloat16, *,
                    body: Optional[str] = None,
                    splits: Optional[int] = None) -> DwPlan:
    """The plan of ``element_dw``'s product ``x^T g`` on x (m, rows) and
    g (m, cols) of an element-mode ``spec``: :func:`block_dw_plan`'s rule
    for one bank tile of rows x cols whose chain is one virtual tile, so
    the pieces cut M alone (ceil(m / 64) K tiles).  bf16 takes the
    tensor cores when rows and columns are multiples of 8; at
    qwen3-1.7b's widths and M = 1024 no split is kept (16 K tiles a
    piece, 128 to 768 output tiles of 128 x 128)."""
    if spec.mode != "element":
        raise ValueError("element_dw_plan takes element-mode specs")
    return _dw_plan("element_dw", m, 1, spec.virtual_shape, 1, dtype, body,
                    splits)


def block_dw(x: torch.Tensor, g: torch.Tensor, spec: H.HashedSpec, *,
             plan: Optional[DwPlan] = None) -> torch.Tensor:
    """dbank (bank_tiles, brow, bcol) fp32 from x (M, R) and the upstream
    grad g (M, C) of y = x @ V, block mode; ``plan`` (default
    :func:`block_dw_plan`) picks the body and the split count."""
    if x.device.type == "cpu":
        return hashed_dw_ref(x, g, spec)
    _check_block_grid("block_dw", spec)
    _check("block_dw", x, spec.rows)
    g = _grad_rows("block_dw", x, g, spec.cols)
    _, sgn, order, offsets, heavy = block_tables(spec, x.device)
    brow, bcol = spec.block_shape
    plan = plan or block_dw_plan(x.shape[0], spec, x.dtype)
    tc = plan.body == "tensor_core"
    if tc:
        x, g = _build.aligned16(x), _build.aligned16(g)
    dbank = torch.empty((spec.bank_tiles, brow, bcol), dtype=torch.float32,
                        device=x.device)
    ws = torch.empty((plan.splits, spec.bank_tiles, brow, bcol),
                     dtype=torch.float32, device=x.device) \
        if tc and plan.splits > 1 else None
    fn = _build.bind("hashed_block", "hashed_block_dw",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(g), _build.ptr(order),
            _build.ptr(offsets), _build.ptr(sgn), _build.ptr(heavy),
            _build.ptr(dbank), _build.ptr(ws), x.shape[0], spec.rows,
            spec.cols, brow, bcol, spec.tile_grid[1], spec.bank_tiles,
            _build.DTYPE_CODE[x.dtype], int(tc), plan.splits,
            _build.stream_of(x))
    _build.check(rc, "block_dw")
    block_dw.launches += 1
    block_dw.tensor_core += int(tc)
    return dbank


for _kernel in (element_matmul, element_matmul_t, element_dw, block_matmul,
                block_dw):
    _kernel.launches = 0
block_matmul.transposed = 0
element_matmul.gemv = element_matmul.tensor_core = 0
element_matmul.small = 0
element_dw.tensor_core = 0
block_dw.tensor_core = 0
