"""Gated feed-forward block (SwiGLU), hashed-capable — the PyTorch port
of the JAX package's ``nn/ffn.py`` as far as the qwen3 decoder needs it."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import hashed as H
from repro_torch.nn import layers as L


@dataclasses.dataclass(frozen=True)
class FFNPlan:
    d_model: int
    d_ff: int
    dtype: Any = torch.bfloat16
    hash_in: Optional[H.HashedSpec] = None
    hash_gate: Optional[H.HashedSpec] = None
    hash_out: Optional[H.HashedSpec] = None
    hash_path: str = "pallas"

    def lin(self, name: str) -> L.LinearPlan:
        i, o, h = {"in": (self.d_model, self.d_ff, self.hash_in),
                   "gate": (self.d_model, self.d_ff, self.hash_gate),
                   "out": (self.d_ff, self.d_model, self.hash_out)}[name]
        return L.LinearPlan(i, o, hashed=h, dtype=self.dtype,
                            hash_path=self.hash_path)


def init(plan: FFNPlan, generator, device="cpu"):
    return {name: L.linear_init(plan.lin(name), generator, device)
            for name in ("in", "gate", "out")}


def apply(plan: FFNPlan, params, x: torch.Tensor) -> torch.Tensor:
    h = L.linear_apply(plan.lin("in"), params["in"], x)
    g = L.linear_apply(plan.lin("gate"), params["gate"], x)
    return L.linear_apply(plan.lin("out"), params["out"], F.silu(g) * h)
