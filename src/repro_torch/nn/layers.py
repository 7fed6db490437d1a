"""Base layers of the PyTorch port: linear (dense or hashed), RMSNorm,
embeddings, rotary position embedding.

Plain functions on tensors, as in the JAX package's ``nn/layers.py``:
every ``*_init`` takes a ``torch.Generator`` and returns a params dict
with the JAX package's leaf names; every ``*_apply`` is a pure function
of (plan, params, inputs).  The paper's technique enters through
``LinearPlan.hashed``: a HashedNets bank in place of the dense weight.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import hashed as H


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinearPlan:
    in_dim: int
    out_dim: int
    hashed: Optional[H.HashedSpec] = None
    dtype: Any = torch.bfloat16
    hash_path: str = "pallas"             # materialize | scan | pallas | auto


def _normal(generator, shape, scale, dtype, device):
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return (w * scale).to(dtype)


def linear_init(plan: LinearPlan, generator, device="cpu"):
    scale = 1.0 / math.sqrt(plan.in_dim)
    if plan.hashed is not None:
        spec = plan.hashed
        if spec.virtual_shape != (plan.in_dim, plan.out_dim):
            raise ValueError(f"spec {spec.virtual_shape} does not match "
                             f"{(plan.in_dim, plan.out_dim)}")
        return {"w": H.init(generator, spec, scale=scale, dtype=plan.dtype,
                            device=device)}
    return {"w": _normal(generator, (plan.in_dim, plan.out_dim), scale,
                         plan.dtype, device)}


def linear_apply(plan: LinearPlan, params, x: torch.Tensor) -> torch.Tensor:
    w = params["w"]
    if plan.hashed is not None:
        # policy-resolved specs carry their own per-slot execution path;
        # hand-built specs (exec_path "") fall back to the plan's
        return H.matmul(x, w, plan.hashed,
                        path=plan.hashed.exec_path or plan.hash_path,
                        dtype=x.dtype)
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6):
    """RMSNorm with (1 + scale) parameterization, computed in fp32."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + params["scale"].float())).to(dt)


# ---------------------------------------------------------------------------
# embeddings (dense or hashed virtual table)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EmbeddingPlan:
    vocab: int
    dim: int
    hashed: Optional[H.HashedSpec] = None
    dtype: Any = torch.bfloat16
    scale_by_sqrt_dim: bool = False   # gemma convention


def embedding_init(plan: EmbeddingPlan, generator, device="cpu"):
    # std 1/sqrt(dim): keeps tied logits (x @ emb^T) at unit scale
    scale = 1.0 / math.sqrt(plan.dim)
    if plan.hashed is not None:
        return {"emb": H.init(generator, plan.hashed, scale=scale,
                              dtype=plan.dtype, device=device)}
    return {"emb": _normal(generator, (plan.vocab, plan.dim), scale,
                           plan.dtype, device)}


def embedding_lookup(plan: EmbeddingPlan, params, tokens: torch.Tensor):
    if plan.hashed is not None:
        x = H.materialize_rows(params["emb"], plan.hashed, tokens)
    else:
        x = params["emb"][tokens.long()]
    if plan.scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(plan.dim), dtype=x.dtype)
    return x


def embedding_logits(plan: EmbeddingPlan, params, x: torch.Tensor):
    """Tied LM head: x @ emb^T with fp32 output, never rounded to the
    activation dtype (the JAX package asks XLA for
    ``preferred_element_type=float32``).

    A plain large matrix product, left to cuBLAS as the JAX package
    leaves it to XLA.  Where autograd records nothing on the card, bf16
    operands go to ``torch.mm(..., out_dtype=float32)`` (fp32
    accumulation and output; the op has no derivative).  Everywhere else
    the operands are cast to fp32, which gives the same products: a bf16
    value is exact in fp32."""
    if plan.hashed is not None:
        emb = H.materialize(params["emb"], plan.hashed, dtype=x.dtype)
    else:
        emb = params["emb"].to(x.dtype)
    records = torch.is_grad_enabled() and (x.requires_grad
                                           or emb.requires_grad)
    if x.is_cuda and x.dtype != torch.float32 and not records:
        x2 = x.reshape(-1, x.shape[-1])
        return torch.mm(x2, emb.t(), out_dtype=torch.float32) \
            .reshape(*x.shape[:-1], emb.shape[0])
    return torch.matmul(x.float(), emb.float().t())


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)
