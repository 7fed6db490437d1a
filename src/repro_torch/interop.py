"""Carry params between the JAX package and the port.

The JAX side hands over its params as a nested dict of numpy arrays with
its own leaf paths and layer-stacked layout (``np.asarray`` on every
leaf), and takes the port's back the same way; this module never
imports the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.device import resolve_device


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes bf16: reinterpret bits
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, cfg: ArchConfig, device=None):
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (default the card), checked against the port's own init
    for leaf paths and shapes."""
    from repro_torch.models.transformer import Model
    dev = resolve_device(device)
    expect = Model(cfg, torch.device("meta")).init_shapes()

    def conv(node, ref, path):
        if isinstance(ref, dict):
            if not isinstance(node, dict) or set(node) != set(ref):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params at {'.'.join(path) or '<root>'}: "
                                 f"keys {got}, expected {sorted(ref)}")
            return {k: conv(node[k], ref[k], path + (k,)) for k in ref}
        t = _to_tensor(node, dev)
        if tuple(t.shape) != ref:
            raise ValueError(f"params at {'.'.join(path)}: shape "
                             f"{tuple(t.shape)}, expected {ref}")
        return t

    return conv(tree, expect, ())


def params_to_numpy(tree):
    """The reverse of :func:`params_from_numpy`: nested dict of tensors ->
    the same nested dict of numpy arrays on the host, with the JAX
    package's leaf paths; bf16 leaves come back bit for bit as numpy's
    "bfloat16" dtype, the one JAX uses (registered with numpy by the JAX
    side's ``ml_dtypes``, which this module never imports)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16) \
            .view(np.dtype("bfloat16"))
    return t.numpy().copy()


def mlp_params_from_numpy(params, spec, device=None, lrd_fixed=None):
    """The JAX package's MLP params (a list of per-layer ``{"w" | "u",
    "b"}`` dicts of numpy arrays) -> ``(params, fixed)`` for
    ``repro_torch.paper``: the same list of tensors on ``device`` (default
    the card), checked against ``paper.mlp.param_shapes``, and the
    per-layer LRD fixed factors: ``lrd_fixed`` (a list of numpy arrays or
    None per layer, e.g. the reference's ``mlp._lrd_fixed``) when given,
    else the port's own (``paper.mlp.fixed_factors``)."""
    from repro_torch.paper import mlp
    dev = resolve_device(device)
    expect = mlp.param_shapes(spec)
    if len(params) != len(expect):
        raise ValueError(f"{len(params)} layers of params, spec has "
                         f"{len(expect)}")
    out = []
    for l, (p, want) in enumerate(zip(params, expect)):
        if set(p) != set(want):
            raise ValueError(f"layer {l}: keys {sorted(p)}, expected "
                             f"{sorted(want)}")
        layer = {k: _to_tensor(p[k], dev) for k in sorted(p)}
        for k, t in layer.items():
            if tuple(t.shape) != want[k]:
                raise ValueError(f"layer {l}.{k}: shape {tuple(t.shape)}, "
                                 f"expected {want[k]}")
        out.append(layer)
    if lrd_fixed is None:
        return out, mlp.fixed_factors(spec, dev)
    fixed = []
    for l, a in enumerate(lrd_fixed):
        want = mlp.lrd_fixed_shape(spec, l) if spec.method == "lrd" else None
        got = None if a is None else tuple(np.shape(a))
        if got != want:
            raise ValueError(f"layer {l}: LRD factor of shape {got}, "
                             f"expected {want}")
        fixed.append(None if a is None else _to_tensor(a, dev))
    return out, fixed


def mlp_params_to_numpy(params):
    """The reverse of :func:`mlp_params_from_numpy` for the params: a list
    of per-layer dicts of numpy arrays on the host."""
    return [{k: v.detach().cpu().numpy().copy() for k, v in p.items()}
            for p in params]
