"""Architecture config schema + registry.

Every assigned architecture is a frozen ArchConfig; `reduced()` derives the
CPU smoke-test variant.  The paper's technique is a config flag (`hashed`)
applicable to any architecture.  This is the PyTorch port's copy of
the JAX package's ``configs/base.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.policy import CompressionPolicy

_REGISTRY: Dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | audio | hybrid | ssm | vlm
    arch_kind: str                   # decoder | encdec | rwkv | zamba
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention
    rope_theta: float = 500000.0
    qk_norm: bool = False
    sliding_window: int = 0          # 0 = full
    global_every: int = 0            # gemma3: every Nth layer full attention
    activation: str = "swiglu"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma: x *= sqrt(d)
    # moe
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    hybrid_group: int = 0            # zamba: mamba layers per shared-attn point
    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub)
    # vlm (llava)
    num_image_tokens: int = 0        # stub patch embeddings prepended
    # paper technique.  The flat knobs below are the legacy uniform
    # configuration; when ``hash_policy`` is set it takes precedence and
    # the flat knobs are ignored (repro_torch.policy.effective) — legacy
    # configs lower into a single-rule policy producing byte-identical
    # HashedSpecs.
    hashed: bool = False
    compression: float = 0.125
    hash_mode: str = "element"       # element | block
    hash_panel_cols: int = 512
    hash_block: Tuple[int, int] = (128, 128)
    hash_embeddings: bool = False
    # execution path for hashed matmuls.  The port's default is the
    # fused-kernel path (the JAX package defaults to "scan"): on the card
    # the other paths would run plain PyTorch code instead of the kernel.
    hash_path: str = "pallas"
    hash_policy: Optional[CompressionPolicy] = None
    # compressed artifact export (repro_torch.artifact)
    artifact_quant: str = "none"     # none | int8 | fp8 bank quantization
    artifact_group: int = 64         # per-group scale granularity
    # numerics / train
    dtype: str = "bfloat16"
    remat: bool = True
    # long-context applicability
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return ((self.vocab_size + 255) // 256) * 256

    def with_(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def hashed_variant(self, compression: float = 0.125,
                       mode: str = "element") -> "ArchConfig":
        return self.with_(hashed=True, compression=compression,
                          hash_mode=mode,
                          name=f"{self.name}-{compression_tag(compression)}")

    def policy_variant(self, policy: CompressionPolicy) -> "ArchConfig":
        """Hashed variant driven by a CompressionPolicy (per-slot rules
        and/or an equal-memory budget)."""
        policy.validate()
        tag = (f"budget{policy.budget:g}" if policy.budget is not None
               else "policy")
        return self.with_(hashed=True, hash_policy=policy,
                          name=f"{self.name}-{tag}")

    def param_count_dense(self) -> int:
        """Approximate dense (virtual) parameter count, for roofline N."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.arch_kind == "rwkv":
            per = 5 * d * d + 2 * d * f + d * d
            return L * per + emb
        if self.arch_kind == "zamba":
            d_in = 2 * d
            per_mamba = d * (2 * d_in + 2 * self.ssm_state
                             + d_in // self.ssm_head_dim) + d_in * d
            shared = d * (hq + 2 * hkv) + hq * d + 3 * d * f
            return L * per_mamba + (L // max(self.hybrid_group, 1)) * shared + emb
        attn = d * (hq + 2 * hkv) + hq * d
        if self.moe:
            ffn = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
        else:
            gates = 3 if self.activation in ("swiglu", "geglu") else 2
            ffn = gates * d * f
        enc = 0
        if self.arch_kind == "encdec":
            enc_attn = 2 * attn  # self + cross in decoder; encoder self
            enc = self.encoder_layers * (attn + 3 * d * f) \
                + L * (attn + 3 * d * f)  # decoder cross-attn approximated in
            return enc + emb
        return L * (attn + ffn) + emb

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D)."""
        if not self.moe:
            return self.param_count_dense()
        d, L = self.d_model, self.num_layers
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        attn = d * (hq + 2 * hkv) + hq * d
        ffn_active = self.top_k * 3 * d * self.moe_d_ff + d * self.num_experts
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return L * (attn + ffn_active) + emb


def compression_tag(compression: float) -> str:
    """Exact name tag for a compression ratio: reciprocal rates keep the
    historical ``hashed8`` form; anything else gets an exact ``hashedc``
    tag (0.3 -> ``hashedc0.3``, not the misleading ``hashed3``).
    ``get`` parses both back (variant-name round-trip)."""
    inv = 1.0 / compression
    if abs(inv - round(inv)) < 1e-9:
        return f"hashed{int(round(inv))}"
    return f"hashedc{compression:g}"


def _parse_variant(name: str) -> Optional["ArchConfig"]:
    """Derive ``<base>[-reduced]-hashedN|-hashedcX`` names not in the
    registry, so variant names round-trip through ``get``."""
    base, sep, tag = name.rpartition("-")
    if not sep or not base:
        return None
    if tag.startswith("hashedc"):
        try:
            compression = float(tag[len("hashedc"):])
        except ValueError:
            return None
    elif tag.startswith("hashed") and tag[len("hashed"):].isdigit():
        compression = 1.0 / int(tag[len("hashed"):])
    else:
        return None
    reduce_it = base.endswith("-reduced")
    if reduce_it:
        base = base[: -len("-reduced")]
    if base not in _REGISTRY:
        return None
    cfg = _REGISTRY[base]
    if reduce_it:
        from repro_torch.configs.reduced import reduced
        cfg = reduced(cfg)
    cfg = cfg.hashed_variant(compression)
    # the tag must regenerate exactly, else the name would drift on the
    # next round-trip
    return cfg if cfg.name == name else None


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (ensure registration side effects)
    if name in _REGISTRY:
        return _REGISTRY[name]
    derived = _parse_variant(name)
    if derived is not None:
        return derived
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def names():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
