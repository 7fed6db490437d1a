"""Reduced same-family configs for CPU smoke tests.

Each assigned architecture gets a tiny sibling: same kind (decoder / encdec
/ rwkv / zamba), same structural features (GQA ratio, local:global pattern,
MoE routing, SSM state), but small widths/layers/vocab so one forward +
train step runs on CPU in seconds.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


def reduced(cfg: ArchConfig) -> ArchConfig:
    kw = dict(
        name=f"{cfg.name}-reduced",
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads,
                                4 * cfg.num_kv_heads // max(cfg.num_heads, 1),
                                4)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        remat=False,
    )
    if cfg.arch_kind == "zamba":
        kw.update(num_layers=4, hybrid_group=2, ssm_state=16,
                  ssm_head_dim=16, ssm_chunk=8, num_heads=4, num_kv_heads=4)
    elif cfg.arch_kind == "rwkv":
        kw.update(num_layers=2, num_heads=4, num_kv_heads=4)
    elif cfg.arch_kind == "encdec":
        kw.update(num_layers=2, encoder_layers=2, encoder_seq=24)
    else:
        kw.update(num_layers=2 if cfg.global_every == 0
                  else 2 * cfg.global_every)
    if cfg.moe:
        kw.update(num_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=32)
    if cfg.sliding_window:
        kw.update(sliding_window=8)
    if cfg.num_image_tokens:
        kw.update(num_image_tokens=8)
    if cfg.hashed:
        kw.update(hash_panel_cols=0)
    return dataclasses.replace(cfg, **kw)
