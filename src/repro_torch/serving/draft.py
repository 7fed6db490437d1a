"""Draft-model derivation for self-speculative decoding (the PyTorch port
of the JAX package's ``serving/draft.py``).

HashedNets' hash functions are stateless and seeded per *slot*
(``models.transformer._slot_seed`` keys on the slot name only), so the
served weights can be re-addressed at any compression ratio: a
``CompressionPolicy`` rung below the served one is a free draft model
sharing the served model's seeds, layout and tokenizer.

The draft bank is the least-squares projection of the served virtual
matrix onto the draft's weight-sharing pattern: with ``V_d[i,j] =
xi_d(i,j) * w_d[h_d(i,j)]``, minimizing ``||V_d - V||^2`` gives

    w_d[b] = mean_{(i,j): h_d(i,j)=b}  xi_d(i,j) * V[i,j]

a signed segment mean of the served virtual matrix over the draft's
buckets (``index_add_`` of the values and of their counts).  On the card
``index_add_`` sums a bucket's values in no fixed order, so a draft bank
may differ in its last bits from run to run: that is acceptable, because
the draft never decides an emitted token (every token is the base
model's own draw, ``serving.spec_decode``); it only sets how many
proposals verify.  When a slot's draft spec equals its served spec the
leaf aliases the served tensor (the same storage, no copy): the equal
rung of the ladder.  Dense leaves (norms, untouched projections) always
alias.  The projection runs one layer at a time: a full-width fp32
virtual matrix is 50 MB at ``ffn.in``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple, Union

import torch

from repro_torch.core import hashed as H
from repro_torch.policy import rules as POL

DraftSpec = Union[str, float, POL.CompressionPolicy]


def resolve_draft_policy(spec: DraftSpec, base_cfg) -> POL.CompressionPolicy:
    """Lower a CLI-ish draft spec into a CompressionPolicy.

    Accepts a ready policy, a ratio (``0.0625`` / ``"1/16"``) or a path to
    a policy JSON.  A ratio keeps the served model's mode, panel width,
    tile shape and execution path, so the draft's buckets line up with the
    served banks (the same panels give the same per-panel hash streams)
    and the draft runs the same kernels: a config whose flat knobs lower
    to a single ``*`` rule hands that rule's values to the defaults (the
    JAX package keeps the class defaults there, which agree with them for
    its element-mode configs)."""
    if isinstance(spec, POL.CompressionPolicy):
        spec.validate()
        return spec
    if isinstance(spec, str) and (spec.endswith(".json")
                                  or os.path.isfile(spec)):
        return POL.load(spec)
    ratio = POL.parse_ratio(spec) if isinstance(spec, str) else float(spec)
    if not (0.0 < ratio <= 1.0):
        raise ValueError(f"draft compression must be in (0, 1], got {ratio}")
    if not base_cfg.hashed:
        return POL.CompressionPolicy(rules=(), compression=ratio,
                                     path=base_cfg.hash_path)
    base_pol = POL.effective(base_cfg)
    if base_cfg.hash_policy is None:
        r = base_pol.rules[0]
        base_pol = dataclasses.replace(
            base_pol, mode=r.mode, panel_cols=r.panel_cols,
            block_shape=tuple(r.block_shape), path=r.path)
    return dataclasses.replace(base_pol, rules=(), budget=None,
                               compression=ratio)


def _project_bank(v: torch.Tensor, spec: H.HashedSpec) -> torch.Tensor:
    """Least-squares bank for one virtual matrix v (rows, cols), fp32."""
    dev = v.device
    if spec.mode == "element":
        i = torch.arange(spec.rows, dtype=torch.int64, device=dev)[:, None]
        j = torch.arange(spec.cols, dtype=torch.int64, device=dev)[None, :]
        idx, sgn = H.element_indices(spec, i, j)
        flat = idx.reshape(-1)
        num = torch.zeros(spec.num_buckets, dtype=torch.float32, device=dev)
        num.index_add_(0, flat, (v * sgn.to(v.dtype)).reshape(-1))
        cnt = torch.zeros_like(num)
        cnt.index_add_(0, flat, torch.ones_like(flat, dtype=v.dtype))
        return num / torch.clamp(cnt, min=1.0)
    idx, sgn = H.block_indices(spec, dev)                  # (gi, gj)
    gi, gj = spec.tile_grid
    bm, bn = spec.block_shape
    vp = torch.nn.functional.pad(
        v, (0, gj * bn - spec.cols, 0, gi * bm - spec.rows))
    tiles = vp.reshape(gi, bm, gj, bn).permute(0, 2, 1, 3)
    tiles = tiles.reshape(gi * gj, bm, bn) \
        * sgn.reshape(-1, 1, 1).to(v.dtype)
    flat = idx.reshape(-1)
    num = torch.zeros((spec.bank_tiles, bm, bn), dtype=torch.float32,
                      device=dev)
    num.index_add_(0, flat, tiles)
    cnt = torch.zeros(spec.bank_tiles, dtype=torch.float32, device=dev)
    cnt.index_add_(0, flat, torch.ones_like(flat, dtype=v.dtype))
    return num / torch.clamp(cnt, min=1.0)[:, None, None]


def _transform_leaf(base_leaf, base_spec, draft_spec, vshape):
    """Served leaf -> draft leaf for one slot, one layer at a time (the
    leaf may be stacked over layers): each layer's served virtual matrix
    (materialized from its bank, or the dense matrix) projected onto the
    draft bank, or left dense, in the served leaf's dtype."""
    per_layer = (len(base_spec.real_param_shape())
                 if base_spec is not None else len(vshape))
    lead = tuple(base_leaf.shape[:base_leaf.dim() - per_layer])
    layers = base_leaf.reshape((-1,) + tuple(base_leaf.shape[len(lead):]))
    shape = (tuple(draft_spec.real_param_shape()) if draft_spec is not None
             else tuple(vshape))
    out = torch.empty((layers.shape[0],) + shape, dtype=base_leaf.dtype,
                      device=base_leaf.device)
    for li in range(layers.shape[0]):
        w = layers[li]
        v = (H.materialize(w, base_spec, dtype=torch.float32)
             if base_spec is not None
             else w.reshape(vshape).float())
        res = _project_bank(v, draft_spec) if draft_spec is not None else v
        out[li] = res.reshape(shape).to(out.dtype)
        del v, res
    return out.reshape(lead + shape)


def derive_draft_params(base_cfg, draft_cfg, params):
    """The draft model's params from the served ones, per leaf: the served
    tensor itself when both specs agree (dense == dense or an identical
    HashedSpec), else the projection of the served virtual matrix onto the
    draft's bank (or the dense matrix)."""
    from repro_torch.models import transformer as T

    base_specs = T.bank_spec_map(base_cfg)
    draft_specs = T.bank_spec_map(draft_cfg)
    slots = {s.path: s for s in T.hash_slots(draft_cfg)}

    def fill(sub, path):
        if isinstance(sub, dict):
            return {k: fill(sub[k], path + (k,)) for k in sub}
        bspec, dspec = base_specs.get(path), draft_specs.get(path)
        if bspec == dspec:                        # includes dense == dense
            return sub
        return _transform_leaf(sub, bspec, dspec, slots[path].virtual_shape)

    return fill(params, ())


def build_draft(base_cfg, params, draft_policy: DraftSpec,
                ) -> Tuple[object, object, object]:
    """(draft_cfg, draft_model, draft_params) for a served model, on the
    params' device.  The draft config is the served config re-pointed at
    the draft policy; seeds do not depend on the ratio, so every draft
    bank re-addresses the served banks' hash streams."""
    from repro_torch.models import build

    policy = resolve_draft_policy(draft_policy, base_cfg)
    draft_cfg = base_cfg.policy_variant(policy).with_(
        name=f"{base_cfg.name}-draft")
    device = params["final_norm"]["scale"].device
    draft_model = build(draft_cfg, device=device)
    with torch.no_grad():
        draft_params = derive_draft_params(base_cfg, draft_cfg, params)
    return draft_cfg, draft_model, draft_params
