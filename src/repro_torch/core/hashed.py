"""HashedNets parameterization (Chen et al., ICML 2015), PyTorch port.

A *virtual* 2-D weight matrix ``V`` of shape ``(rows, cols)`` is
represented by a small *real* parameter bank ``w``:

- ``element`` mode (paper-faithful, Eq. 3/7): ``V[i, j] = xi(i, j) *
  w[h(i, j)]``, with the bucket space optionally stratified into column
  panels of ``panel_cols`` columns (bucket = panel * Kp + h % Kp).
- ``block`` mode: tile(ti, tj) = sigma(ti, tj) * bank[h(ti, tj)].

:class:`HashedSpec` is framework-free and identical to the JAX
package's (same fields, same ``to_dict``), so specs and policy JSON
cross between the two packages unchanged.

Execution paths of :func:`matmul`, all computing ``x @ V``:

- ``"materialize"`` — build V explicitly, one matmul;
- ``"scan"``        — a loop over column panels, one panel of V live at a
                      time (the counterpart of the JAX ``lax.scan`` path);
- ``"pallas"``      — the fused decompress-GEMM kernel
                      (``repro_torch.kernels.ops.hashed_matmul``): the
                      hand-written CUDA kernel on the card, its plain
                      PyTorch version on the CPU.  The name is the JAX
                      package's, so reference policy JSON still resolves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hashing


@dataclasses.dataclass(frozen=True)
class HashedSpec:
    """Static description of one hashed virtual matrix."""

    virtual_shape: Tuple[int, int]  # (rows, cols); used as x @ V
    compression: float              # c = real params / virtual params
    mode: str = "element"           # "element" | "block"
    seed: int = 0
    panel_cols: int = 0             # element mode: 0 => global bucket space
    block_shape: Tuple[int, int] = (128, 128)
    use_sign: bool = True
    # Execution hint, NOT part of the matrix's identity: which matmul path
    # the policy picked for this slot ("" = caller's default).  Excluded
    # from equality/serialization so policy-resolved specs stay
    # byte-identical to pre-policy ones (see repro.policy).
    exec_path: str = dataclasses.field(default="", compare=False)

    # ---- derived sizes -------------------------------------------------
    @property
    def rows(self) -> int:
        return self.virtual_shape[0]

    @property
    def cols(self) -> int:
        return self.virtual_shape[1]

    @property
    def virtual_size(self) -> int:
        return self.rows * self.cols

    @property
    def n_panels(self) -> int:
        if self.mode != "element":
            raise ValueError("n_panels is element-mode only")
        if self.panel_cols <= 0:
            return 1
        return max(1, math.ceil(self.cols / self.panel_cols))

    @property
    def buckets_per_panel(self) -> int:
        k_total = max(self.n_panels, int(round(self.compression * self.virtual_size)))
        return max(1, k_total // self.n_panels)

    @property
    def num_buckets(self) -> int:
        """Real parameter count, element mode."""
        return self.buckets_per_panel * self.n_panels

    @property
    def tile_grid(self) -> Tuple[int, int]:
        bm, bn = self.block_shape
        return (math.ceil(self.rows / bm), math.ceil(self.cols / bn))

    @property
    def num_tiles(self) -> int:
        gi, gj = self.tile_grid
        return gi * gj

    @property
    def bank_tiles(self) -> int:
        return max(1, int(round(self.compression * self.num_tiles)))

    def real_param_shape(self) -> Tuple[int, ...]:
        if self.mode == "element":
            return (self.num_buckets,)
        bm, bn = self.block_shape
        return (self.bank_tiles, bm, bn)

    def real_param_count(self) -> int:
        return int(np.prod(self.real_param_shape()))

    def validate(self) -> None:
        if self.mode not in ("element", "block"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if not (0.0 < self.compression <= 1.0):
            raise ValueError("compression must be in (0, 1]")
        if self.mode == "block":
            bm, bn = self.block_shape
            if bm <= 0 or bn <= 0:
                raise ValueError(f"bad block_shape {self.block_shape}")
            # Non-divisible virtual shapes are allowed: the tile grid is
            # ceil-sized and every consumer slices back to (rows, cols).
            # Only the fused Pallas kernel requires exact divisibility
            # (checked in repro.kernels.ops at dispatch).

    # ---- serialization (artifact header / registry metadata) -----------
    def to_dict(self) -> dict:
        """JSON-safe description; exact inverse of :func:`spec_from_dict`.

        Everything needed to regenerate the virtual matrix from the bank
        alone — this is what the paper's storage claim rests on: the hash
        is stateless, so an artifact stores only these few scalars + the
        real parameters."""
        return {
            "virtual_shape": [int(x) for x in self.virtual_shape],
            "compression": float(self.compression),
            "mode": self.mode,
            "seed": int(self.seed),
            "panel_cols": int(self.panel_cols),
            "block_shape": [int(x) for x in self.block_shape],
            "use_sign": bool(self.use_sign),
        }


def spec_to_dict(spec: HashedSpec) -> dict:
    return spec.to_dict()


def spec_from_dict(d: dict) -> HashedSpec:
    spec = HashedSpec(
        virtual_shape=tuple(int(x) for x in d["virtual_shape"]),
        compression=float(d["compression"]),
        mode=str(d["mode"]),
        seed=int(d["seed"]),
        panel_cols=int(d.get("panel_cols", 0)),
        block_shape=tuple(int(x) for x in d.get("block_shape", (128, 128))),
        use_sign=bool(d.get("use_sign", True)),
    )
    spec.validate()
    return spec


# ---------------------------------------------------------------------------
# initialization
# ---------------------------------------------------------------------------

def init(generator: torch.Generator, spec: HashedSpec,
         scale: Optional[float] = None, dtype=torch.float32,
         device="cpu") -> torch.Tensor:
    """Initialize the real bank so that the *virtual* matrix has fan-in
    scaled variance: ``w ~ N(0, scale^2)`` gives ``Var(V_ij) = scale^2``
    because xi decorrelates colliding entries."""
    spec.validate()
    if scale is None:
        scale = 1.0 / math.sqrt(spec.rows)
    w = torch.empty(spec.real_param_shape(), dtype=torch.float32,
                    device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# index computation (shared by every path; the CUDA kernel recomputes it)
# ---------------------------------------------------------------------------

def element_indices(spec: HashedSpec, i, j):
    """Bucket index + sign for absolute virtual coordinates (i, j)
    (int64 tensors, broadcastable).  Panel-local stratification:
    bucket = panel * Kp + h(i,j) % Kp."""
    kp = spec.buckets_per_panel
    j = torch.as_tensor(j, dtype=torch.int64)
    i = torch.as_tensor(i, dtype=torch.int64, device=j.device)
    if spec.panel_cols > 0:
        panel = j // spec.panel_cols
    else:
        panel = torch.zeros_like(j)
    idx = panel * kp + hashing.bucket_hash(i, j, kp, spec.seed)
    if spec.use_sign:
        sgn = hashing.sign_hash(i, j, spec.seed)
    else:
        sgn = torch.ones_like(idx)
    return idx, sgn


def block_indices(spec: HashedSpec, device="cpu"):
    """Tile->bank index map + per-tile sign for the whole tile grid."""
    gi, gj = spec.tile_grid
    ti = torch.arange(gi, dtype=torch.int64, device=device)[:, None]
    tj = torch.arange(gj, dtype=torch.int64, device=device)[None, :]
    idx = hashing.bucket_hash(ti, tj, spec.bank_tiles, spec.seed)
    if spec.use_sign:
        sgn = hashing.sign_hash(ti, tj, spec.seed)
    else:
        sgn = torch.ones_like(idx)
    return idx, sgn


# ---------------------------------------------------------------------------
# materialization (oracle / small layers)
# ---------------------------------------------------------------------------

def _element_block(w, spec: HashedSpec, i, j, dtype):
    idx, sgn = element_indices(spec, i, j)
    return (w[idx] * sgn.to(w.dtype)).to(dtype)


def materialize(w: torch.Tensor, spec: HashedSpec, dtype=None):
    """Build the full virtual matrix V (rows, cols)."""
    spec.validate()
    dtype = dtype or w.dtype
    dev = w.device
    if spec.mode == "element":
        i = torch.arange(spec.rows, dtype=torch.int64, device=dev)[:, None]
        j = torch.arange(spec.cols, dtype=torch.int64, device=dev)[None, :]
        return _element_block(w, spec, i, j, dtype)
    idx, sgn = block_indices(spec, dev)
    gi, gj = spec.tile_grid
    bm, bn = spec.block_shape
    tiles = w[idx] * sgn[..., None, None].to(w.dtype)      # (gi,gj,bm,bn)
    v = tiles.permute(0, 2, 1, 3).reshape(gi * bm, gj * bn)
    return v[: spec.rows, : spec.cols].to(dtype)


def materialize_rows(w: torch.Tensor, spec: HashedSpec, row_ids,
                     dtype=None):
    """Gather virtual rows V[row_ids, :] without building all of V
    (hashed embedding lookup): row_ids (...,) -> (..., cols)."""
    spec.validate()
    dtype = dtype or w.dtype
    rid = torch.as_tensor(row_ids, dtype=torch.int64, device=w.device)
    if spec.mode == "element":
        j = torch.arange(spec.cols, dtype=torch.int64, device=w.device)
        return _element_block(w, spec, rid[..., None], j, dtype)
    bm, bn = spec.block_shape
    gi, gj = spec.tile_grid
    idx, sgn = block_indices(spec, w.device)                # (gi, gj)
    trow, roff = rid // bm, rid % bm
    row_tiles = w[idx[trow]] * sgn[trow][..., None, None].to(w.dtype)
    # (..., gj, bm, bn) -> the one row each id needs: (..., gj, bn)
    gidx = roff[..., None, None, None].expand(
        *rid.shape, gj, 1, bn)
    sliced = torch.gather(row_tiles, -2, gidx).squeeze(-2)
    out = sliced.reshape(*rid.shape, gj * bn)
    return out[..., : spec.cols].to(dtype)


# ---------------------------------------------------------------------------
# matmul paths
# ---------------------------------------------------------------------------

def matmul_scan(x: torch.Tensor, w: torch.Tensor, spec: HashedSpec,
                panel_cols: int = 0, dtype=None):
    """x @ V with one column panel of V live at a time (the counterpart
    of the JAX package's ``lax.scan`` path).  Element mode walks panels of
    ``panel_cols`` columns; block mode walks one tile column per step."""
    spec.validate()
    dtype = dtype or x.dtype
    cols = spec.cols
    if spec.mode == "block":
        bm, bn = spec.block_shape
        gi, gj = spec.tile_grid
        idx, sgn = block_indices(spec, x.device)            # (gi, gj)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        rpad = gi * bm - spec.rows
        if rpad:
            # ragged tile grid: zero-pad the contraction dim (zero columns
            # of x meet the padded virtual rows)
            x2 = torch.nn.functional.pad(x2, (0, rpad))
        outs = []
        for tj in range(gj):
            tiles = w[idx[:, tj]] * sgn[:, tj, None, None].to(w.dtype)
            outs.append(x2 @ tiles.reshape(gi * bm, bn).to(dtype))
        y = torch.cat(outs, dim=-1)[:, :cols]
        return y.reshape(*lead, cols)
    if panel_cols <= 0:
        panel_cols = spec.panel_cols if spec.panel_cols > 0 \
            else min(cols, 1024)
    if spec.panel_cols > 0 and panel_cols % spec.panel_cols \
            and spec.panel_cols % panel_cols:
        panel_cols = spec.panel_cols
    i = torch.arange(spec.rows, dtype=torch.int64, device=x.device)[:, None]
    outs = []
    for j0 in range(0, cols, panel_cols):
        j = torch.arange(j0, min(j0 + panel_cols, cols), dtype=torch.int64,
                         device=x.device)[None, :]
        outs.append(x @ _element_block(w, spec, i, j, dtype))
    return torch.cat(outs, dim=-1)


def matmul(x: torch.Tensor, w: torch.Tensor, spec: HashedSpec,
           path: str = "auto", dtype=None, panel_cols: int = 0):
    """Dispatch x @ V over execution paths.

    path: "materialize" | "scan" | "pallas" | "auto" ("auto":
    materialize for small virtual matrices, the panel loop otherwise).
    """
    spec.validate()
    dtype = dtype or x.dtype
    if path == "auto":
        path = "materialize" if spec.virtual_size <= (4096 * 4096) \
            else "scan"
    if path == "materialize":
        return x @ materialize(w, spec, dtype=dtype)
    if path == "scan":
        return matmul_scan(x, w, spec, panel_cols=panel_cols, dtype=dtype)
    if path == "pallas":
        from repro_torch.kernels import ops as kernel_ops
        return kernel_ops.hashed_matmul(x, w, spec, dtype=dtype)
    raise ValueError(f"unknown path {path!r}")
