"""Element-mode fused decompress-GEMM ``y = x @ V`` for HashedNets.

Kernel: ``csrc/hashed_matmul.cu`` (CUDA C++, sm_90a).  It replaces the
JAX package's ``kernels/hashed_matmul.py`` ``_element_fwd_kernel`` /
``element_matmul(transpose=False)``.  Each block computes a (BM x 64)
output tile; for every 32 x 64 tile of V it recomputes the bucket index
and sign of each virtual weight from the murmur hash, gathers the bank
value from global memory (the panel's bucket slice is 512 KB - 1.5 MB at
full width, too big for shared memory, so it is served from L2), and
reuses the decompressed tile for all BM rows.  What bounds it on the
H100 is the hashing of all R x C virtual weights per BM-row block, not
bytes or the product: a decode step hashes all 1.41 G virtual weights of
qwen3-1.7b.  Split-K over an fp32 workspace (reduced in split order, so
deterministic) keeps enough blocks in flight when M is small.

The plain version :func:`hashed_matmul_ref` (the port of the JAX
package's ``kernels/ref.py`` ``hashed_matmul_ref``) materializes V in
fp32.  The CPU path takes it; on a CUDA tensor the wrapper launches the
kernel or raises.  The transpose (``dx``) and ``dw`` backward kernels and
the block-mode kernels are not ported yet (ROADMAP Queue B items 5-8).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import hashed as H
from repro_torch.kernels import _build

_SMS = 132          # H100 SXM streaming multiprocessors
_BN, _BK = 64, 32   # tile sizes of csrc/hashed_matmul.cu


def hashed_matmul_ref(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec,
                      dtype=None) -> torch.Tensor:
    """y = x @ V with V materialized in fp32 (the plain version)."""
    if x.is_cuda:
        hashed_matmul_ref.cuda_calls += 1
    dtype = dtype or x.dtype
    v = H.materialize(w, spec, dtype=torch.float32)
    return (x.float() @ v).to(dtype)


hashed_matmul_ref.cuda_calls = 0


def split_count(m: int, r: int, c: int) -> int:
    """Split-K factor: enough (column, row, split) blocks for two waves
    over the card's SMs, without splits shorter than one K tile."""
    bm = 8 if m <= 8 else 64
    blocks = -(-c // _BN) * -(-m // bm)
    splits = 1
    while blocks * splits < 2 * _SMS and (splits * 2) * _BK <= r:
        splits *= 2
    return splits


def element_matmul(x: torch.Tensor, w: torch.Tensor, spec: H.HashedSpec, *,
                   out_dtype=None) -> torch.Tensor:
    """x (M, R) @ V -> (M, C), element mode, R = spec.rows."""
    if spec.mode != "element":
        raise ValueError("element_matmul takes element-mode specs")
    m, r = x.shape
    if r != spec.rows:
        raise ValueError(f"x {tuple(x.shape)} does not match spec "
                         f"{spec.virtual_shape}")
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return hashed_matmul_ref(x, w, spec, out_dtype)
    _build.require_cuda(x, "element_matmul")
    if x.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"element_matmul: dtype {x.dtype} not supported")
    w = w.to(x.dtype)
    if not (x.is_contiguous() and w.is_contiguous() and w.device == x.device):
        raise ValueError("element_matmul: x and w must be contiguous and "
                         "on one device")
    if w.numel() != spec.num_buckets:
        raise ValueError(f"bank has {w.numel()} values, spec wants "
                         f"{spec.num_buckets}")
    c = spec.cols
    y = torch.empty((m, c), dtype=x.dtype, device=x.device)
    splits = split_count(m, r, c)
    ws = torch.empty((splits, m, c), dtype=torch.float32,
                     device=x.device) if splits > 1 else None
    fn = _build.bind("hashed_matmul", "hashed_element_matmul",
                     [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                     + [ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    rc = fn(_build.ptr(x), _build.ptr(w), _build.ptr(y), _build.ptr(ws),
            m, r, c, spec.buckets_per_panel, spec.panel_cols,
            spec.seed & 0xFFFFFFFF, int(spec.use_sign),
            _build.DTYPE_CODE[x.dtype], splits, _build.stream_of(x))
    _build.check(rc, "hashed_element_matmul")
    element_matmul.launches += 1
    return y if out_dtype == x.dtype else y.to(out_dtype)


element_matmul.launches = 0
