"""Public entry point of the hashed decompress-GEMM kernel.

``hashed_matmul(x, w, spec)`` accepts arbitrary leading batch dims, pads
the flattened row count to the block multiple the JAX package's wiring
picks (``kernels/ops.py`` ``_pick_bm`` / ``_pad_rows``), and dispatches
the element-mode kernel (its plain version for CPU tensors).  Forward
only: the custom-VJP backward kernels come with training (ROADMAP Queue
B items 5-6), block mode with item 7.
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


def hashed_matmul(x: torch.Tensor, w: torch.Tensor, spec: hashed.HashedSpec,
                  dtype=None, block=(128, 128, 128)) -> torch.Tensor:
    """y = x @ decompress(w, spec) through the fused kernel (forward)."""
    spec.validate()
    if spec.mode != "element":
        raise NotImplementedError(
            "block-mode hashed GEMM kernel: ROADMAP Queue B item 7")
    dtype = dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    x2, m = _pad_rows(x2, _pick_bm(x2.shape[0], block[0]))
    y = hk.element_matmul(x2, w, spec, out_dtype=dtype)
    return y[:m].reshape(*lead, spec.cols)
