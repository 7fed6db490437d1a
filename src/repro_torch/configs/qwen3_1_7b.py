"""Qwen3-1.7B [hf:Qwen/Qwen3-1.7B]: 28L, d=2048, 16H GQA kv=8,
head_dim=128, d_ff=6144, vocab=151936, qk-norm, tied embeddings."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-1.7b", family="dense", arch_kind="decoder",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=6144, vocab_size=151936,
    rope_theta=1000000.0, activation="swiglu", qk_norm=True,
    tie_embeddings=True,
))
