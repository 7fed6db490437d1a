"""Fused decompress-GEMM kernels of HashedNets and their gradients.

Kernels (CUDA C++, sm_90a), one wrapper each, replacing the JAX
package's ``kernels/hashed_matmul.py``:

- :func:`element_matmul` — ``y = x @ V``, element mode
  (``csrc/hashed_matmul.cu``; ``element_matmul(transpose=False)``);
- :func:`element_matmul_t` — ``dx = g @ V^T``, the same kernel body
  with the virtual coordinates swapped (``element_matmul(transpose=True)``);
- :func:`element_dw` — the bank gradient of paper Eq. 12
  (``csrc/hashed_dw.cu``; ``element_dw``);
- :func:`block_matmul` — ``x @ V`` or ``x @ V^T`` in block mode
  (``csrc/hashed_block.cu``; ``block_matmul``);
- :func:`block_dw` — the block-mode bank gradient (same source;
  ``block_dw``).

The element-mode GEMM recomputes each virtual weight's bucket and sign
from the murmur hash inside the kernel and reuses each decompressed
32 x 64 tile of V for all rows of a block; the block-mode GEMM stages
dense bank tiles.  What bounds them on the H100 is the hashing (element
mode) and the fp32 FMA loop, not bytes: see the sources.  Split-K over
an fp32 workspace (reduced in split order) keeps enough blocks in
flight when M is small.  Both ``dw`` kernels are bitwise deterministic:
no float atomics; each bucket or bank tile is summed in a fixed order
over a static map of the virtual positions that hash to it, built once
per spec on the device and cached here.

The plain versions are the ports of the JAX package's ``kernels/ref.py``
oracles (``hashed_matmul_ref``, ``hashed_matmul_t_ref``,
``hashed_dw_ref``): they materialize V in fp32 and take either mode.
The CPU path takes them; on a CUDA tensor each wrapper launches its
kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import hashed as H
from repro_torch.kernels import _build

_SMS = 132          # H100 SXM streaming multiprocessors
_BN, _BK = 64, 32   # output / contraction tile of csrc/tile_gemm.cuh


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
    """Inverse hash map of an element-mode spec: every virtual position
    i * cols + j grouped by bucket.  4 bytes per virtual weight (plus the
    bucket offsets), built on ``device`` and cached for the process."""
    key = ("element", spec, str(device))
    if key not in _MAPS:
        if spec.virtual_size >= 2 ** 31:
            raise ValueError(f"element_dw: {spec.virtual_shape} has more "
                             f"than 2**31 virtual positions")
        i = torch.arange(spec.rows, dtype=torch.int64, device=device)[:, None]
        j = torch.arange(spec.cols, dtype=torch.int64, device=device)[None, :]
        idx, _ = H.element_indices(spec, i, j)
        _MAPS[key] = _segments(idx.reshape(-1), spec.num_buckets)
    return _MAPS[key]


def block_tables(spec: H.HashedSpec, device):
    """(idx, sgn, order, offsets), int32 on ``device``, cached: the
    row-major (gi, gj) tile -> bank map and tile signs, and the virtual
    tiles grouped by bank tile in the JAX kernel's stable-argsort order."""
    key = ("block", spec, str(device))
    if key not in _MAPS:
        idx, sgn = H.block_indices(spec, device)
        idx = idx.reshape(-1)
        _MAPS[key] = (idx.to(torch.int32), sgn.reshape(-1).to(torch.int32),
                      *_segments(idx, spec.bank_tiles))
    return _MAPS[key]


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def split_count(m: int, k: int, n: int) -> int:
    """Split-K factor: enough (column, row, split) blocks for two waves
    over the card's SMs, without splits shorter than one K tile."""
    bm = 8 if m <= 8 else 64
    blocks = -(-n // _BN) * -(-m // bm)
    splits = 1
    while blocks * splits < 2 * _SMS and (splits * 2) * _BK <= k:
        splits *= 2
    return splits


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


def _gemm_out(x: torch.Tensor, n: int):
    """Output and split-K workspace of a (M, K) @ (K, n) kernel GEMM."""
    m, k = x.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits = split_count(m, k, n)
    ws = torch.empty((splits, m, n), dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    return y, ws, splits


def _element_gemm(x, w, spec, transpose: bool):
    what = "element_matmul_t" if transpose else "element_matmul"
    if spec.mode != "element":
        raise ValueError(f"{what} takes element-mode specs")
    k, n = (spec.cols, spec.rows) if transpose else (spec.rows, spec.cols)
    _check(what, x, k)
    w = _bank(what, w, x)
    if w.numel() != spec.num_buckets:
        raise ValueError(f"bank has {w.numel()} values, spec wants "
                         f"{spec.num_buckets}")
    y, ws, splits = _gemm_out(x, n)
    fn = _build.bind("hashed_matmul", "hashed_element_matmul",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                     + [ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(y), _build.ptr(ws),
            x.shape[0], k, n, spec.buckets_per_panel, spec.panel_cols,
            spec.seed & 0xFFFFFFFF, int(spec.use_sign),
            _build.DTYPE_CODE[x.dtype], splits, int(transpose),
            _build.stream_of(x))
    _build.check(rc, what)
    return y


def element_matmul(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                   out_dtype=None) -> torch.Tensor:
    """x (M, R) @ V -> (M, C), element mode."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return hashed_matmul_ref(x, w, spec, out_dtype)
    y = _element_gemm(x, w, spec, transpose=False)
    element_matmul.launches += 1
    return y if out_dtype == x.dtype else y.to(out_dtype)


def element_matmul_t(g: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                     out_dtype=None) -> torch.Tensor:
    """g (M, C) @ V^T -> (M, R), element mode (the input gradient)."""
    out_dtype = out_dtype or g.dtype
    if g.device.type == "cpu":
        return hashed_matmul_t_ref(g, w, spec, out_dtype)
    y = _element_gemm(g, w, spec, transpose=True)
    element_matmul_t.launches += 1
    return y if out_dtype == g.dtype else y.to(out_dtype)


def element_dw(x: torch.Tensor, g: torch.Tensor,
               spec: H.HashedSpec) -> torch.Tensor:
    """dw (num_buckets,) fp32 from x (M, R) and the upstream grad g (M, C)
    of y = x @ V, element mode."""
    if x.device.type == "cpu":
        return hashed_dw_ref(x, g, spec)
    if spec.mode != "element":
        raise ValueError("element_dw takes element-mode specs")
    _check("element_dw", x, spec.rows)
    g = _grad_rows("element_dw", x, g, spec.cols)
    order, offsets = element_segments(spec, x.device)
    ws = torch.empty(spec.virtual_size, dtype=torch.float32, device=x.device)
    dw = torch.empty(spec.num_buckets, dtype=torch.float32, device=x.device)
    fn = _build.bind("hashed_dw", "hashed_element_dw",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                     + [ctypes.c_uint] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(g), _build.ptr(ws), _build.ptr(order),
            _build.ptr(offsets), _build.ptr(dw), x.shape[0], spec.rows,
            spec.cols, spec.seed & 0xFFFFFFFF, int(spec.use_sign),
            spec.num_buckets, _build.DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check(rc, "element_dw")
    element_dw.launches += 1
    return dw


def _check_block_grid(what: str, spec: H.HashedSpec):
    if spec.mode != "block":
        raise ValueError(f"{what} takes block-mode specs")
    brow, bcol = spec.block_shape
    if spec.rows % brow or spec.cols % bcol:
        raise ValueError(f"{what} needs block_shape {spec.block_shape} to "
                         f"divide virtual_shape {spec.virtual_shape}")


def block_matmul(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                 transpose: bool = False, out_dtype=None) -> torch.Tensor:
    """x (M, R) @ V -> (M, C), or with ``transpose`` g (M, C) @ V^T ->
    (M, R), block mode; w is the bank (bank_tiles, brow, bcol).
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
    idx, sgn, _, _ = block_tables(spec, x.device)
    y, ws, splits = _gemm_out(x, n)
    brow, bcol = spec.block_shape
    fn = _build.bind("hashed_block", "hashed_block_matmul",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(idx), _build.ptr(sgn),
            _build.ptr(y), _build.ptr(ws), x.shape[0], k, n, brow, bcol,
            spec.tile_grid[1], _build.DTYPE_CODE[x.dtype], splits,
            int(transpose), _build.stream_of(x))
    _build.check(rc, "block_matmul")
    block_matmul.launches += 1
    block_matmul.transposed += int(transpose)
    return y if out_dtype == x.dtype else y.to(out_dtype)


def block_dw(x: torch.Tensor, g: torch.Tensor,
             spec: H.HashedSpec) -> torch.Tensor:
    """dbank (bank_tiles, brow, bcol) fp32 from x (M, R) and the upstream
    grad g (M, C) of y = x @ V, block mode."""
    if x.device.type == "cpu":
        return hashed_dw_ref(x, g, spec)
    _check_block_grid("block_dw", spec)
    _check("block_dw", x, spec.rows)
    g = _grad_rows("block_dw", x, g, spec.cols)
    _, sgn, order, offsets = block_tables(spec, x.device)
    brow, bcol = spec.block_shape
    dbank = torch.empty((spec.bank_tiles, brow, bcol), dtype=torch.float32,
                        device=x.device)
    fn = _build.bind("hashed_block", "hashed_block_dw",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(g), _build.ptr(order),
            _build.ptr(offsets), _build.ptr(sgn), _build.ptr(dbank),
            x.shape[0], spec.rows, spec.cols, brow, bcol, spec.tile_grid[1],
            spec.bank_tiles, _build.DTYPE_CODE[x.dtype], _build.stream_of(x))
    _build.check(rc, "block_dw")
    block_dw.launches += 1
    return dbank


for _kernel in (element_matmul, element_matmul_t, element_dw, block_matmul,
                block_dw):
    _kernel.launches = 0
block_matmul.transposed = 0
