"""Public entry point of the hashed decompress-GEMM kernels.

``hashed_matmul(x, w, spec)`` accepts arbitrary leading batch dims, pads
the flattened row count to the block multiple the JAX package's wiring
picks (``kernels/ops.py`` ``_pick_bm`` / ``_pad_rows``), dispatches the
element- or block-mode kernel, and is differentiable: a
``torch.autograd.Function`` in place of the JAX package's custom VJP,
whose backward runs kernels too (paper Eq. 12): ``dx`` through the
transpose GEMM, ``dw`` through the deterministic bank-gradient kernel.
``dx`` comes back in ``x.dtype``; ``dw`` is computed in fp32 and cast to
the bank's dtype, as in the JAX package.  On CPU tensors every step runs
the kernels' plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import hashed
from repro_torch.kernels import hashed_matmul as hk


def _pad_rows(x2: torch.Tensor, bm: int):
    m = x2.shape[0]
    pad = (-m) % bm
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    return x2, m


def _pick_bm(m: int, target: int = 128) -> int:
    """Largest power-of-two block <= target that keeps padding waste small."""
    bm = target
    while bm > 8 and m % bm and m < bm:
        bm //= 2
    return bm


def _rows(t: torch.Tensor, block):
    """(M, K) contiguous view of ``t``'s rows, padded to the row block,
    and the true row count."""
    t2 = t.reshape(-1, t.shape[-1]).contiguous()
    return _pad_rows(t2, _pick_bm(t2.shape[0], block[0]))


def _fwd_impl(x, w, spec, dtype, block):
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m = x2.shape[0]
    if not hk.gemv_ok(m, spec.mode, transpose=False):
        # the gemv body runs at the true row count (M a template: one FMA
        # per weight at M = 1); the others take the padded row block
        x2, m = _pad_rows(x2, _pick_bm(m, block[0]))
    if spec.mode == "element":
        y = hk.element_matmul(x2, w, spec, out_dtype=dtype)
    else:
        y = hk.block_matmul(x2, w, spec, out_dtype=dtype)
    return y[:m].reshape(*x.shape[:-1], spec.cols)


def _bwd_dx_impl(g, w, spec, dtype, block):
    g2, m = _rows(g, block)
    if spec.mode == "element":
        dx = hk.element_matmul_t(g2, w, spec, out_dtype=dtype)
    else:
        dx = hk.block_matmul(g2, w, spec, transpose=True, out_dtype=dtype)
    return dx[:m].reshape(*g.shape[:-1], spec.rows)


def _bwd_dw_impl(x, g, spec, block):
    x2, _ = _rows(x, block)
    g2, _ = _rows(g, block)
    if spec.mode == "element":
        return hk.element_dw(x2, g2, spec)
    return hk.block_dw(x2, g2, spec)


class _HashedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, spec, dtype, block):
        ctx.save_for_backward(x, w)
        ctx.spec, ctx.block = spec, block
        return _fwd_impl(x, w, spec, dtype, block)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _bwd_dx_impl(g, w, ctx.spec, x.dtype, ctx.block)
        if ctx.needs_input_grad[1]:
            dw = _bwd_dw_impl(x, g, ctx.spec, ctx.block).to(w.dtype)
        return dx, dw, None, None, None


def hashed_matmul(x: torch.Tensor, w: torch.Tensor, spec: hashed.HashedSpec,
                  dtype=None, block=(128, 128, 128)) -> torch.Tensor:
    """y = x @ decompress(w, spec) through the fused kernel, differentiable
    in x and w."""
    spec.validate()
    if spec.mode == "block":
        bm_, bn_ = spec.block_shape
        if spec.rows % bm_ or spec.cols % bn_:
            raise ValueError(
                f"pallas block path needs block_shape {spec.block_shape} to "
                f"divide virtual_shape {spec.virtual_shape}; use the scan or "
                f"materialize path for ragged grids")
    dtype, block = dtype or x.dtype, tuple(block)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _HashedMatmul.apply(x, w, spec, dtype, block)
    # nothing to differentiate (serving): skip the Function's ~20 us of
    # host time per call, which a host-bound decode step pays 196 times
    return _fwd_impl(x, w, spec, dtype, block)
