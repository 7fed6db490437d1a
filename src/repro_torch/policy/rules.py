"""Declarative compression policies: per-slot hashing rules.

The paper's experiments (§5, §6) vary compression *per layer* and compare
networks at *equal storage*; related work goes further (Functional Hashing
configures hashing per layer, Structured Multi-Hashing allocates one
parameter budget across the whole model).  This module is that API: a
:class:`CompressionPolicy` is an ordered list of :class:`PolicyRule`\\ s
matched against *slot paths* — the dotted param-leaf paths of
``models.transformer.bank_spec_map`` with the trailing ``w`` leaf dropped,
e.g. ``layers.attn.q``, ``layers.moe.in``, ``embed.emb``, ``lm_head`` —
plus policy-wide defaults and an optional equal-memory *budget* solved by
:mod:`repro_torch.policy.budget`.

Matching is first-rule-wins ``fnmatch`` globbing (``layers.attn.*``,
``*.ffn.out``, ``embed.*``); a slot no rule matches uses the policy
defaults.  The legacy flat ``ArchConfig`` knobs (``compression``,
``hash_mode``, ...) lower into a single ``*`` rule via :func:`from_flat`,
so pre-policy configs resolve to byte-identical ``HashedSpec``\\ s.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.hashed import HashedSpec
from repro_torch.policy import budget as budget_mod

MODES = ("element", "block")
# "pallas" keeps the JAX package's name for the fused-kernel path, so
# reference policy JSON resolves unchanged; in this package it selects
# the hand-written CUDA kernel (its plain version on the CPU).
EXEC_PATHS = ("auto", "materialize", "scan", "pallas")
QUANT_SCHEMES = ("none", "int8", "fp8")


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One per-slot override.  Every field except ``match`` is optional;
    unset fields fall through to the policy defaults.  ``floor``/``cap``
    bound the budget solver's allocation for matched slots (a slot with an
    explicit ``compression`` is pinned and excluded from budget solving)."""

    match: str                                   # glob over slot paths
    hashed: Optional[bool] = None                # False => leave dense
    compression: Optional[float] = None          # pinned ratio
    mode: Optional[str] = None                   # element | block
    panel_cols: Optional[int] = None             # element-mode panels
    block_shape: Optional[Tuple[int, int]] = None
    path: Optional[str] = None                   # execution path
    quant: Optional[str] = None                  # artifact quant override
    floor: Optional[float] = None                # budget lower bound
    cap: Optional[float] = None                  # budget upper bound

    def validate(self) -> None:
        if not self.match:
            raise ValueError("rule needs a non-empty match pattern")
        if self.mode is not None and self.mode not in MODES:
            raise ValueError(f"rule {self.match!r}: mode {self.mode!r} "
                             f"not in {MODES}")
        if self.path is not None and self.path not in EXEC_PATHS:
            raise ValueError(f"rule {self.match!r}: path {self.path!r} "
                             f"not in {EXEC_PATHS}")
        if self.quant is not None and self.quant not in QUANT_SCHEMES:
            raise ValueError(f"rule {self.match!r}: quant {self.quant!r} "
                             f"not in {QUANT_SCHEMES}")
        for name in ("compression", "floor", "cap"):
            v = getattr(self, name)
            if v is not None and not (0.0 < v <= 1.0):
                raise ValueError(f"rule {self.match!r}: {name}={v} "
                                 f"outside (0, 1]")
        if (self.floor is not None and self.cap is not None
                and self.floor > self.cap):
            raise ValueError(f"rule {self.match!r}: floor {self.floor} > "
                             f"cap {self.cap}")
        if self.block_shape is not None:
            bm, bn = self.block_shape
            if bm <= 0 or bn <= 0:
                raise ValueError(f"rule {self.match!r}: bad block_shape "
                                 f"{self.block_shape}")


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Ordered rules + defaults + optional equal-memory budget.

    ``budget`` is the target ratio of total REAL parameters to total
    virtual (dense) parameters across all hashed slots; when set, slots
    without a pinned per-rule ``compression`` get solver-allocated ratios
    (see :mod:`repro_torch.policy.budget`) so the whole model lands on the
    requested storage — the paper's equal-memory comparison as one knob."""

    rules: Tuple[PolicyRule, ...] = ()
    budget: Optional[float] = None
    # defaults for slots (or fields) no rule decides
    compression: float = 0.125
    mode: str = "element"
    panel_cols: int = 512
    block_shape: Tuple[int, int] = (128, 128)
    path: str = "scan"

    def validate(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"default mode {self.mode!r} not in {MODES}")
        if self.path not in EXEC_PATHS:
            raise ValueError(f"default path {self.path!r} not in "
                             f"{EXEC_PATHS}")
        if not (0.0 < self.compression <= 1.0):
            raise ValueError(f"default compression {self.compression} "
                             f"outside (0, 1]")
        if self.budget is not None and not (0.0 < self.budget <= 1.0):
            raise ValueError(f"budget {self.budget} outside (0, 1]")
        for r in self.rules:
            r.validate()

    def match(self, slot_path: str) -> Optional[PolicyRule]:
        """First rule whose glob matches ``slot_path`` (None = defaults)."""
        for r in self.rules:
            if fnmatch.fnmatchcase(slot_path, r.match):
                return r
        return None


def from_flat(*, compression: float, mode: str, panel_cols: int,
              block_shape: Tuple[int, int], path: str) -> CompressionPolicy:
    """Lower the legacy flat ArchConfig knobs into a single-rule policy.

    Resolution through this policy must be byte-identical to the pre-policy
    ``_hspec`` formula (same seeds/shapes/bucket counts) — the compat
    contract tested in tests/test_policy.py."""
    return CompressionPolicy(rules=(PolicyRule(
        match="*", compression=compression, mode=mode,
        panel_cols=panel_cols, block_shape=tuple(block_shape), path=path),))


def effective(cfg) -> CompressionPolicy:
    """The policy an ArchConfig actually runs under: its ``hash_policy``
    if set, else the compat lowering of its flat knobs."""
    if getattr(cfg, "hash_policy", None) is not None:
        return cfg.hash_policy
    return from_flat(compression=cfg.compression, mode=cfg.hash_mode,
                     panel_cols=cfg.hash_panel_cols,
                     block_shape=tuple(cfg.hash_block), path=cfg.hash_path)


# ---------------------------------------------------------------------------
# slots + resolution
# ---------------------------------------------------------------------------

def slot_path(path: Tuple) -> str:
    """Param-leaf path tuple -> dotted slot path rules match against.

    The trailing ``w`` leaf is dropped (``("layers","attn","q","w")`` ->
    ``layers.attn.q``); MoE banks and embeddings have no ``w`` leaf and
    keep all components (``layers.moe.in``, ``embed.emb``)."""
    parts = [str(p) for p in path]
    if len(parts) > 1 and parts[-1] == "w":
        parts = parts[:-1]
    return ".".join(parts)


@dataclasses.dataclass(frozen=True)
class Slot:
    """One hashable projection in a model: where it lives in the param
    tree, its dense (virtual) shape, and the seed its hash pattern derives
    from.  ``default_on`` encodes the legacy gating (embeddings/lm_head
    hash only under ``hash_embeddings``) that rules may override."""

    path: Tuple[str, ...]            # param-leaf path in the model pytree
    virtual_shape: Tuple[int, int]
    seed: int
    default_on: bool = True

    @property
    def dotted(self) -> str:
        return slot_path(self.path)

    @property
    def virtual_size(self) -> int:
        return self.virtual_shape[0] * self.virtual_shape[1]


@dataclasses.dataclass(frozen=True)
class SlotAssignment:
    """Resolution output for one slot: the spec (None = left dense), which
    rule decided it, and the artifact quant override if any."""

    slot: Slot
    spec: Optional[HashedSpec]
    rule: Optional[str]              # matched rule's pattern, None=defaults
    quant: Optional[str] = None


def _pick(rule: Optional[PolicyRule], field: str, default):
    if rule is not None and getattr(rule, field) is not None:
        return getattr(rule, field)
    return default


def resolve(policy: CompressionPolicy, slots: Sequence[Slot]
            ) -> Dict[Tuple[str, ...], SlotAssignment]:
    """Match every slot against the policy and build its HashedSpec.

    Slots a rule pins (explicit ``compression``) keep that ratio; with a
    ``budget`` set, the remaining hashed slots get solver-allocated ratios
    so total real params land on ``budget * total_virtual``."""
    policy.validate()
    matched = []
    for slot in slots:
        rule = policy.match(slot.dotted)
        on = slot.default_on if (rule is None or rule.hashed is None) \
            else rule.hashed
        matched.append((slot, rule, on))

    ratios: Dict[Tuple[str, ...], float] = {}
    if policy.budget is not None:
        hashed_on = [(s, r) for s, r, on in matched if on]
        total_virtual = sum(s.virtual_size for s, _ in hashed_on)
        target = policy.budget * total_virtual
        fixed_real = 0.0
        free = []
        for s, r in hashed_on:
            pinned = r.compression if r is not None else None
            if pinned is not None:
                fixed_real += pinned * s.virtual_size
            else:
                lo = _pick(r, "floor", 0.0)
                hi = _pick(r, "cap", 1.0)
                # at least one real parameter per slot
                lo = max(lo, 1.0 / max(s.virtual_size, 1))
                free.append((s.path, s.virtual_size, lo, max(lo, hi)))
        ratios = budget_mod.solve(target, free, fixed_real=fixed_real)

    out: Dict[Tuple[str, ...], SlotAssignment] = {}
    for slot, rule, on in matched:
        pattern = rule.match if rule is not None else None
        if not on:
            out[slot.path] = SlotAssignment(slot, None, pattern)
            continue
        mode = _pick(rule, "mode", policy.mode)
        comp = _pick(rule, "compression",
                     ratios.get(slot.path, policy.compression))
        panel = _pick(rule, "panel_cols", policy.panel_cols)
        spec = HashedSpec(
            virtual_shape=tuple(slot.virtual_shape),
            compression=float(comp),
            mode=mode,
            seed=slot.seed,
            panel_cols=(panel if mode == "element" else 0),
            block_shape=tuple(_pick(rule, "block_shape",
                                    policy.block_shape)),
            exec_path=_pick(rule, "path", policy.path),
        )
        spec.validate()
        out[slot.path] = SlotAssignment(slot, spec, pattern,
                                        quant=_pick(rule, "quant", None))
    return out


# ---------------------------------------------------------------------------
# serialization (policy JSON files, ArchConfig dicts, artifact headers)
# ---------------------------------------------------------------------------

_RULE_FIELDS = {f.name for f in dataclasses.fields(PolicyRule)}
_POLICY_FIELDS = {f.name for f in dataclasses.fields(CompressionPolicy)}


def rule_from_dict(d: dict, *, strict: bool = True) -> PolicyRule:
    """strict=True (user-authored files): unknown keys are typos — raise.
    strict=False (artifact/registry read path): drop unknown keys so
    files written by newer versions stay readable (same forward-compat
    contract as ``format.config_from_dict``)."""
    unknown = set(d) - _RULE_FIELDS
    if unknown and strict:
        raise ValueError(f"unknown rule keys {sorted(unknown)} "
                         f"(known: {sorted(_RULE_FIELDS)})")
    kw = {k: v for k, v in d.items() if k in _RULE_FIELDS}
    if kw.get("block_shape") is not None:
        kw["block_shape"] = tuple(int(x) for x in kw["block_shape"])
    r = PolicyRule(**kw)
    r.validate()
    return r


def policy_from_dict(d: dict, *, strict: bool = True) -> CompressionPolicy:
    """Inverse of :func:`policy_to_dict`; also accepts the user-facing
    file layout where defaults sit under a ``"default"`` sub-object.
    See :func:`rule_from_dict` for ``strict``."""
    kw = dict(d)
    kw.update(kw.pop("default", {}) or {})
    unknown = set(kw) - _POLICY_FIELDS
    if unknown and strict:
        raise ValueError(f"unknown policy keys {sorted(unknown)} "
                         f"(known: {sorted(_POLICY_FIELDS)})")
    kw = {k: v for k, v in kw.items() if k in _POLICY_FIELDS}
    kw["rules"] = tuple(
        r if isinstance(r, PolicyRule)
        else rule_from_dict(r, strict=strict)
        for r in kw.get("rules", ()) or ())
    if kw.get("block_shape") is not None:
        kw["block_shape"] = tuple(int(x) for x in kw["block_shape"])
    p = CompressionPolicy(**kw)
    p.validate()
    return p


def policy_to_dict(policy: CompressionPolicy) -> dict:
    """JSON-safe dict; exact inverse of :func:`policy_from_dict`."""
    d = dataclasses.asdict(policy)
    d["rules"] = [dict(r) for r in d["rules"]]
    for r in d["rules"]:
        if r.get("block_shape") is not None:
            r["block_shape"] = list(r["block_shape"])
    d["block_shape"] = list(d["block_shape"])
    return d


def load(path: str) -> CompressionPolicy:
    """Read a policy JSON file (``launch/train --policy``)."""
    with open(path) as f:
        return policy_from_dict(json.load(f))


def dump(policy: CompressionPolicy, path: str) -> None:
    with open(path, "w") as f:
        json.dump(policy_to_dict(policy), f, indent=1, sort_keys=True)


def parse_ratio(text: str) -> float:
    """CLI budget/compression ratios: ``0.125`` or ``1/8``."""
    if "/" in text:
        num, _, den = text.partition("/")
        return float(num) / float(den)
    return float(text)
