"""Grouped-query attention with RoPE and qk-norm, every projection
optionally hashed — the PyTorch port of the JAX package's
``nn/attention.py``: ``apply`` without a cache (training) and with a
dense KV cache (the engine's scratch-cache prefill, ``decode_step``),
``attend``, ``_attend_unchunked`` and the paged serving paths.

Shapes: x (B, S, d_model); dense cache (B, T_max, n_kv, head_dim) and
page pools (P, page_size, n_kv, head_dim) per k/v.  GQA runs without
repeating K/V; scores and softmax are fp32.

PyTorch runs eagerly, so caches and pools are updated in place: the JAX
package returns new ones (the engine donates the paged pools,
``serving/engine.py`` ``donate_argnums``, which XLA turns into the same
in-place update).  Not ported yet: cross-attention and the spec-decode
``apply_paged_block`` (ROADMAP Queue A items 11 and 8).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.core import hashed as H
from repro_torch.kernels import flash_prefill as FP
from repro_torch.kernels import paged_attention as PA
from repro_torch.nn import layers as L

IMPLS = ("ref", "pallas")


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full attention
    dtype: Any = torch.bfloat16
    hash_q: Optional[H.HashedSpec] = None
    hash_k: Optional[H.HashedSpec] = None
    hash_v: Optional[H.HashedSpec] = None
    hash_o: Optional[H.HashedSpec] = None
    hash_path: str = "pallas"

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def lin(self, name: str) -> L.LinearPlan:
        i, o, h = {"q": (self.d_model, self.q_dim, self.hash_q),
                   "k": (self.d_model, self.kv_dim, self.hash_k),
                   "v": (self.d_model, self.kv_dim, self.hash_v),
                   "o": (self.q_dim, self.d_model, self.hash_o)}[name]
        return L.LinearPlan(i, o, hashed=h, dtype=self.dtype,
                            hash_path=self.hash_path)


def init(plan: AttentionPlan, generator, device="cpu"):
    params = {name: L.linear_init(plan.lin(name), generator, device)
              for name in ("q", "k", "v", "o")}
    if plan.qk_norm:
        params["q_norm"] = L.rmsnorm_init(plan.head_dim, device=device)
        params["k_norm"] = L.rmsnorm_init(plan.head_dim, device=device)
    return params


def _project(plan: AttentionPlan, params, name: str, x: torch.Tensor,
             out_heads: int) -> torch.Tensor:
    y = L.linear_apply(plan.lin(name), params[name], x)
    return y.reshape(x.shape[0], x.shape[1], out_heads, plan.head_dim)


def _qkv(plan: AttentionPlan, params, x, positions):
    """Projections, qk-norm and RoPE at ``positions`` (B, S)."""
    q = _project(plan, params, "q", x, plan.num_heads)
    k = _project(plan, params, "k", x, plan.num_kv_heads)
    v = _project(plan, params, "v", x, plan.num_kv_heads)
    if plan.qk_norm:
        q = L.rmsnorm_apply(params["q_norm"], q)
        k = L.rmsnorm_apply(params["k_norm"], k)
    q = L.rope(q, positions, plan.rope_theta)
    k = L.rope(k, positions, plan.rope_theta)
    return q, k, v


def attend(plan: AttentionPlan, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, q_pos: torch.Tensor,
           kv_pos: Optional[torch.Tensor] = None,
           kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal grouped attention, memory-bounded.

    q (B, S, Hq, D); k/v (B, T, Hkv, D); q_pos (S,) or (B, S) query
    positions; kv_pos (T,) key positions (default q_pos: self-attention
    over the sequence); kv_valid (T,) or (B, T), whether a key slot holds
    a real key (default all).  Sequences longer than 2048 run the
    queries in chunks of 512, so the live score tensor is (B, Hkv, G,
    512, T); every query row's softmax still spans all keys, so the
    result equals the unchunked one.  Returns (B, S, Hq * D).
    """
    s = q.shape[1]
    if kv_pos is None:
        kv_pos = q_pos
    if kv_valid is None:
        kv_valid = torch.ones(kv_pos.shape[-1:], dtype=torch.bool,
                              device=q.device)
    if s <= 2048:
        return _attend_unchunked(plan, q, k, v, q_pos, kv_pos, kv_valid)
    return torch.cat([
        _attend_unchunked(plan, q[:, c0:c0 + 512], k, v,
                          q_pos[..., c0:c0 + 512], kv_pos, kv_valid)
        for c0 in range(0, s, 512)], dim=1)


def _attend_unchunked(plan: AttentionPlan, q, k, v, q_pos, kv_pos,
                      kv_valid) -> torch.Tensor:
    b, s, hq, d = q.shape
    n_kv = plan.num_kv_heads
    qg = q.reshape(b, s, n_kv, hq // n_kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst",
                          qg.float() * (1.0 / math.sqrt(d)), k.float())
    # q_pos (S,) or (B, S), kv_valid (T,) or (B, T): masks (B|1, S, T)
    qp = q_pos if q_pos.dim() == 2 else q_pos[None, :]
    valid = kv_valid if kv_valid.dim() == 2 else kv_valid[None, :]
    dist = qp[:, :, None] - kv_pos[None, None, :]
    mask = valid[:, None, :] & (dist >= 0)
    if plan.sliding_window > 0:
        mask = mask & (dist < plan.sliding_window)
    scores = torch.where(mask[:, None, None], scores, torch.tensor(
        -1e30, dtype=torch.float32, device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    # bf16 probs for the value product, as the JAX package does
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq * d).to(plan.dtype)


def init_cache(plan: AttentionPlan, batch: int, max_len: int, device):
    """A zero dense KV cache (k, v), each (B, max_len, Hkv, D)."""
    shape = (batch, max_len, plan.num_kv_heads, plan.head_dim)
    return (torch.zeros(shape, dtype=plan.dtype, device=device),
            torch.zeros(shape, dtype=plan.dtype, device=device))


def apply(plan: AttentionPlan, params, x: torch.Tensor, *,
          positions: torch.Tensor, cache=None,
          cache_index=None) -> torch.Tensor:
    """Self-attention.  x (B, S, d); positions (S,) or (B, S).  Returns
    (B, S, d_model).

    - ``cache=None`` (training): attends within x.
    - ``cache=(ck, cv)``, each (B, T_max, Hkv, D): the step's K/V are
      written in place at ``cache_index`` (an int, or a (B,) tensor of
      per-row offsets) and the queries attend over the cache's slots
      below ``cache_index + S``.  A write past ``T_max`` is an error (the
      JAX package's ``dynamic_update_slice`` would clamp it, shifting
      the write).
    """
    s = x.shape[1]
    q, k, v = _qkv(plan, params, x, positions)
    if cache is None:
        out = attend(plan, q, k, v, positions)
    else:
        ck, cv = cache
        t_max = ck.shape[1]
        kv_pos = torch.arange(t_max, device=x.device)
        if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
            idx = cache_index.to(device=x.device, dtype=torch.int64)
            assert int(idx.max()) + s <= t_max, (idx.tolist(), s, t_max)
            rows = torch.arange(x.shape[0], device=x.device)[:, None]
            cols = idx[:, None] + torch.arange(s, device=x.device)[None, :]
            ck[rows, cols] = k.to(ck.dtype)
            cv[rows, cols] = v.to(cv.dtype)
            kv_valid = kv_pos[None, :] < (idx[:, None] + s)       # (B, T)
        else:
            idx = int(cache_index)
            assert idx + s <= t_max, (idx, s, t_max)
            ck[:, idx:idx + s] = k.to(ck.dtype)
            cv[:, idx:idx + s] = v.to(cv.dtype)
            kv_valid = kv_pos < idx + s
        out = attend(plan, q, ck, cv, positions, kv_pos, kv_valid)
    return L.linear_apply(plan.lin("o"), params["o"], out)


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not in {IMPLS}")


def apply_paged(plan: AttentionPlan, params, x: torch.Tensor, *, pages,
                page_table: torch.Tensor, lengths: torch.Tensor,
                impl: str = "pallas") -> torch.Tensor:
    """One decode step (S=1) through a paged KV cache.

    x: (B, 1, d_model); pages: (pk, pv) each (P, ps, Hkv, D), written in
    place; page_table: (B, MAXP) int32; lengths: (B,) int32 tokens
    already cached per row EXCLUDING the current one (its k/v lands at
    page ``table[b, lengths // ps]`` offset ``lengths % ps``).

    impl: "ref" (the kernel's plain gather-then-attend version) or
    "pallas" (the paged flash-decode kernel; its plain version on the
    CPU).  Returns out (B, 1, d_model).
    """
    _check_impl(impl)
    b = x.shape[0]
    lengths = lengths.long()
    q, k, v = _qkv(plan, params, x, lengths[:, None])
    pk, pv = pages
    ps = pk.shape[1]
    pidx = torch.gather(page_table.long(), 1, (lengths // ps)[:, None])[:, 0]
    poff = lengths % ps
    # distinct live rows own distinct pages (allocator invariant); idle
    # rows all write the trash page, collisions harmless there
    pk[pidx, poff] = k[:, 0].to(pk.dtype)
    pv[pidx, poff] = v[:, 0].to(pv.dtype)
    fn = PA.paged_decode_attention if impl == "pallas" \
        else PA.paged_attention_ref
    out = fn(q[:, 0], pk, pv, page_table, (lengths + 1).int(),
             plan.sliding_window)
    out = out.reshape(b, 1, plan.q_dim).to(plan.dtype)
    return L.linear_apply(plan.lin("o"), params["o"], out)


def apply_paged_prefill(plan: AttentionPlan, params, x: torch.Tensor, *,
                        pages, page_table: torch.Tensor,
                        starts: torch.Tensor, counts: torch.Tensor,
                        write_from: torch.Tensor,
                        impl: str = "pallas") -> torch.Tensor:
    """Batched ragged prefill chunk through a paged KV cache.

    x: (B, S, d_model); slot ``s`` of row ``b`` holds the prompt token at
    position ``starts[b] + s`` and is real iff ``s < counts[b]`` (rows
    with ``counts == 0`` are inert padding rows).  Real slots at
    positions >= ``write_from[b]`` write K/V into the row's pages through
    the table (shared prefix pages below it are never written); every
    other slot writes the trash page (0), whose contents are never read.
    Every real slot then attends its causal band over the row's paged
    prefix.  Returns out (B, S, d_model).
    """
    _check_impl(impl)
    b, s_blk, _ = x.shape
    starts = starts.long()
    offs = torch.arange(s_blk, dtype=torch.int64, device=x.device)[None, :]
    positions = starts[:, None] + offs                 # (B, S)
    q, k, v = _qkv(plan, params, x, positions)
    pk, pv = pages
    ps = pk.shape[1]
    maxp = page_table.shape[1]
    wvalid = (offs < counts.long()[:, None]) \
        & (positions >= write_from.long()[:, None])
    # clamp the page slot for padding positions that run past the table;
    # their writes are redirected to the trash page anyway
    pno = torch.clamp(positions // ps, max=maxp - 1)
    pidx = torch.where(wvalid, torch.gather(page_table.long(), 1, pno), 0)
    poff = positions % ps
    pk[pidx.reshape(-1), poff.reshape(-1)] = \
        k.reshape(b * s_blk, *k.shape[2:]).to(pk.dtype)
    pv[pidx.reshape(-1), poff.reshape(-1)] = \
        v.reshape(b * s_blk, *v.shape[2:]).to(pv.dtype)
    fn = FP.paged_prefill_attention if impl == "pallas" \
        else FP.paged_prefill_ref
    out = fn(q, pk, pv, page_table, starts.int(), counts.int(),
             plan.sliding_window)
    out = out.reshape(b, s_blk, plan.q_dim).to(plan.dtype)
    return L.linear_apply(plan.lin("o"), params["o"], out)
