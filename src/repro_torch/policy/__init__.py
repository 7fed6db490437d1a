"""Compression policy subsystem: per-slot hashing rules + equal-memory
budget solving (the API the paper's per-layer/equal-storage experiments
need; see repro_torch.policy.rules for the model).

    from repro_torch import policy
    pol = policy.CompressionPolicy(
        budget=1 / 8,
        rules=(policy.PolicyRule(match="layers.attn.*",
                                 compression=1 / 4),
               policy.PolicyRule(match="embed.*", hashed=False)))
    cfg = C.get("qwen3-1.7b").policy_variant(pol)
"""
from repro_torch.policy.budget import solve  # noqa: F401
from repro_torch.policy.rules import (  # noqa: F401
    CompressionPolicy,
    PolicyRule,
    Slot,
    SlotAssignment,
    dump,
    effective,
    from_flat,
    load,
    parse_ratio,
    policy_from_dict,
    policy_to_dict,
    resolve,
    rule_from_dict,
    slot_path,
)
