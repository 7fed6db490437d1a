"""Optimizers of the PyTorch port: the JAX package's ``train/optimizer.py``.

- ``sgd_momentum``: the paper's optimizer (Chen et al. §6 train HashedNets
  with SGD + momentum + dropout).
- ``adamw``: default for the LLM-scale architectures.  Its formulas are
  the JAX package's (b2 = 0.95; weight decay added to the bias-corrected
  step), which ``torch.optim.AdamW`` does not reproduce.

Functional, on nested dicts of tensors: ``update`` returns new params and
a new state and mutates nothing.  States are fp32 whatever the param
dtype; updates are computed in fp32 and cast back.  Schedules take the
step as an int tensor and return an fp32 0-d tensor, as the JAX ones do.
Leaves are visited in sorted key order (``jax.tree`` order), so the
global-norm sum runs in the same order in both packages.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable    # params -> opt_state
    update: Callable  # (grads, opt_state, params, step) -> (new_params, new_state)


# ---------------------------------------------------------------------------
# trees (jax.tree_util's rules: dicts in sorted key order, lists and tuples
# in order, None an empty subtree)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest``; a ``None`` in ``tree`` holds no leaf and stays ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in tree_leaves
    order); its ``None`` nodes stay ``None``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _unzip(tree, n: int):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree,
                          is_leaf=lambda x: isinstance(x, tuple))
                 for i in range(n))


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def constant_lr(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine_lr(peak: float, warmup_steps: int, total_steps: int,
                     final_frac: float = 0.1):
    def lr(step):
        step = step.float()
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd_momentum(lr_fn, momentum: float = 0.9,
                 weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        lr = lr_fn(step)

        def upd(g, mu, p):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            mu_new = momentum * mu + g32
            p_new = p.float() - lr * mu_new
            return p_new.to(p.dtype), mu_new

        new_params, new_mu = _unzip(
            tree_map(upd, grads, state["mu"], params), 2)
        return new_params, {"mu": new_mu}

    return Optimizer(init, update)


def adamw(lr_fn, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params)}

    def update(grads, state, params, step):
        lr = lr_fn(step)
        t = step.float() + 1.0
        c1 = 1.0 - torch.pow(b1, t)
        c2 = 1.0 - torch.pow(b2, t)

        def upd(g, m, v, p):
            g32 = g.float()
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m_new / c1
            vhat = v_new / c2
            p32 = p.float()
            step_ = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
            return (p32 - lr * step_).to(p.dtype), m_new, v_new

        new_params, m, v = _unzip(
            tree_map(upd, grads, state["m"], state["v"], params), 3)
        return new_params, {"m": m, "v": v}

    return Optimizer(init, update)


def make(name: str, lr_fn=None, **kw) -> Optimizer:
    lr_fn = lr_fn or constant_lr(1e-3)
    if name == "sgd_momentum":
        return sgd_momentum(lr_fn, **kw)
    if name == "adamw":
        return adamw(lr_fn, **kw)
    raise ValueError(name)
