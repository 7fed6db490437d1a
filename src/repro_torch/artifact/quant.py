"""Bank quantization for compressed artifacts: int8 / fp8, per-group scales
(the PyTorch port's copy of the JAX package's ``artifact/quant.py``).

Applied at export to the real parameter banks (and any large dense leaf);
symmetric, per group of ``group`` consecutive elements in flattened order:

    q = round(x / s),   s = absmax(group) / Q     (int8: Q = 127)
    q = fp8(x / s),     s = absmax(group) / 448   (fp8: e4m3 max normal)

Scales are float32, one per group: at group=64 the scale overhead is 1/16
of an fp32 bank (int8 in all: 0.25 + 0.0625, ~3.2x smaller than fp32).

Error bound (int8): per element ``|x - dq| <= 0.5 * s = absmax(group) /
254``.  fp8 e4m3 carries 3 mantissa bits: the error is ``<= 2^-4`` of each
element's own magnitude after scaling.

Everything here is host-side numpy, as in the JAX package, without
``ml_dtypes``: the fp8 cast goes through ``torch.float8_e4m3fn`` (round to
nearest even; ``x / s`` a hair above 448 rounds to 448, never to NaN) and
fp8 codes are held as their uint8 bits, bitwise the JAX package's codes.
A bf16 leaf is quantized from its exact fp32 values and restored as a
``torch.bfloat16`` tensor (numpy has no bf16), so :func:`dequantize`
returns a CPU tensor of the leaf's own dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

SCHEMES = ("none", "int8", "fp8")
FP8_MAX = 448.0        # float8_e4m3fn largest normal
INT8_MAX = 127.0

# dtype names as the JAX package writes them (numpy's names; ml_dtypes'
# for bf16 and fp8) -> torch dtypes
TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float8_e4m3fn": torch.float8_e4m3fn, "int8": torch.int8,
    "uint8": torch.uint8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
# dtypes numpy cannot hold: stored as bits of the same width
_BITS = {"bfloat16": np.int16, "float8_e4m3fn": np.uint8}


def dtype_name(dtype) -> str:
    """The JAX package's name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def itemsize(name: str) -> int:
    return torch.empty((), dtype=TORCH_DTYPES[name]).element_size()


def to_host(x) -> Tuple[np.ndarray, str]:
    """(numpy array holding the leaf's bytes, its dtype name) for a tensor
    or an array: bf16 leaves come back as their int16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        name = dtype_name(t.dtype)
        if name in _BITS:
            return t.view(torch.int16 if name == "bfloat16"
                          else torch.uint8).numpy(), name
        return t.numpy(), name
    a = np.asarray(x)
    return a, dtype_name(a.dtype)


def from_bits(a: np.ndarray, name: str) -> torch.Tensor:
    """A tensor of dtype ``name`` over the numpy array ``a`` (its bits for
    bf16 and fp8), sharing its memory."""
    t = torch.from_numpy(a)
    return t.view(TORCH_DTYPES[name]) if name in _BITS else t


def numpy_view(raw: np.ndarray, name: str) -> np.ndarray:
    """A uint8 buffer viewed as the numpy dtype that holds ``name``."""
    return raw.view(np.dtype(_BITS[name]) if name in _BITS
                    else np.dtype(name))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


@dataclasses.dataclass(frozen=True)
class Quantized:
    """A quantized leaf: stored codes + per-group scales + restore info.
    ``q`` is (n_groups, group) int8, or uint8 holding fp8 e4m3fn bits."""
    q: np.ndarray
    scales: np.ndarray       # (n_groups,) float32
    scheme: str
    group: int
    pad: int                 # zeros appended to fill the last group
    orig_shape: Tuple[int, ...]
    orig_dtype: str

    def dequantize(self) -> torch.Tensor:
        return dequantize(self)


def max_abs_error(scheme: str, scales: np.ndarray) -> float:
    """Worst-case elementwise reconstruction error for a quantized leaf."""
    s = float(np.max(scales)) if np.size(scales) else 0.0
    if scheme == "int8":
        return 0.5 * s
    if scheme == "fp8":
        return s * FP8_MAX * 2.0 ** -4
    return 0.0


def _fp8_bits(scaled: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(scaled)) \
        .to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def quantize(arr, scheme: str, group: int = 64) -> Quantized:
    """Quantize a numpy array or a tensor (any float dtype, bf16 too)."""
    if scheme not in ("int8", "fp8"):
        raise ValueError(f"unknown quant scheme {scheme!r}")
    if group <= 0:
        raise ValueError("group must be positive")
    orig_shape = tuple(int(s) for s in arr.shape)
    orig_dtype = dtype_name(arr.dtype)
    flat = _f32(arr).reshape(-1)
    pad = (-flat.size) % group
    if pad:
        flat = np.pad(flat, (0, pad))
    xg = flat.reshape(-1, group)
    absmax = np.abs(xg).max(axis=1)
    qmax = INT8_MAX if scheme == "int8" else FP8_MAX
    scales = np.where(absmax > 0.0, absmax / qmax, 1.0).astype(np.float32)
    scaled = xg / scales[:, None]
    if scheme == "int8":
        q = np.clip(np.rint(scaled), -INT8_MAX, INT8_MAX).astype(np.int8)
    else:
        q = _fp8_bits(scaled)
    return Quantized(q=q, scales=scales, scheme=scheme, group=group,
                     pad=pad, orig_shape=orig_shape, orig_dtype=orig_dtype)


def dequantize(z: Quantized) -> torch.Tensor:
    """The restored leaf: a CPU tensor of its original dtype and shape."""
    codes = from_bits(np.ascontiguousarray(z.q), stored_dtype(z.scheme))
    xg = codes.float().numpy() * z.scales[:, None]
    flat = xg.reshape(-1)
    if z.pad:
        flat = flat[:flat.size - z.pad]
    return torch.from_numpy(np.ascontiguousarray(flat)) \
        .reshape(z.orig_shape).to(TORCH_DTYPES[z.orig_dtype])


def stored_dtype(scheme: str) -> str:
    return "int8" if scheme == "int8" else "float8_e4m3fn"


def is_float_dtype(dtype) -> bool:
    name = dtype_name(dtype)
    return name.startswith("float") or name == "bfloat16"


def should_quantize(path: Tuple, arr, is_bank: bool,
                    min_size: int = 4096) -> bool:
    """Export policy: quantize every hashed bank, plus any large float
    matrix (embeddings, dense projections).  Norm scales / biases /
    scalars stay exact: they are O(d) bytes and numerically sensitive."""
    if not is_float_dtype(arr.dtype):
        return False
    if is_bank:
        return True
    size = int(np.prod(arr.shape)) if len(arr.shape) else 1
    return len(arr.shape) >= 2 and size >= min_size
