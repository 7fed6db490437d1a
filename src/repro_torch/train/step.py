"""Train step of the PyTorch port: microbatched gradient accumulation,
clipping, optional gradient compression with error feedback and the
optimizer update (the JAX package's ``train/step.py``).

The train state is a plain dict {"params", "opt", "step"} of tensors (and
"residual" with compression), as in the JAX package; ``train_step`` is
functional and returns a new one.  Gradients come from
``torch.autograd.grad`` on detached leaves of the params, so the state
itself never carries autograd history.  Not ported: ``state_pspecs``
(there is no mesh).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import Model
from repro_torch.train import grad_compress
from repro_torch.train.optimizer import (Optimizer, clip_by_global_norm,
                                         tree_leaves, tree_map,
                                         tree_unflatten)


def init_state(model: Model, optimizer: Optimizer, seed: int = 0,
               with_residual: bool = False):
    params = model.init(seed)
    state = {"params": params, "opt": optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if with_residual:
        # error-feedback residuals for compressed gradient exchange
        state["residual"] = grad_compress.init_residual(params)
    return state


def make_train_step(model: Model, optimizer: Optimizer,
                    num_microbatches: int = 1,
                    clip_norm: Optional[float] = 1.0,
                    accum_dtype=torch.bfloat16,
                    grad_compressor: Optional[str] = None,
                    compress_ratio: float = 0.125):
    """Returns train_step(state, batch) -> (state, metrics).

    batch leaves are tensors with leading dim = global batch; with
    num_microbatches > 1 they are split into (MB, B/MB, ...) and the
    grads are summed in ``accum_dtype`` over a loop (bounds activation
    memory), then averaged.

    grad_compressor ("hashed_space" | "int8" | None): compress the
    clipped gradients before the optimizer with error feedback, where the
    JAX step does (``train/grad_compress.py``).  Requires
    ``init_state(..., with_residual=True)``.
    """
    compress = (grad_compress.make_compressor(grad_compressor,
                                              compress_ratio)
                if grad_compressor else None)

    def grad_fn(params, mb):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        loss, metrics = model.train_loss(tree_unflatten(params, leaves), mb)
        grads = torch.autograd.grad(loss, leaves)
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return loss.detach(), metrics, tree_unflatten(params, grads)

    def train_step(state, batch):
        params = state["params"]
        if num_microbatches == 1:
            loss, metrics, grads = grad_fn(params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % num_microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{num_microbatches} microbatches")
                return x.reshape(num_microbatches, b // num_microbatches,
                                 *x.shape[1:])

            mbs = {k: split(v) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss = 0.0
            for i in range(num_microbatches):
                mb_loss, metrics, mb_grads = grad_fn(
                    params, {k: v[i] for k, v in mbs.items()})
                grads = tree_map(lambda a, g: a + g.to(accum_dtype), grads,
                                 mb_grads)
                loss = loss + mb_loss
            grads = tree_map(lambda g: (g.float() / num_microbatches)
                             .to(accum_dtype), grads)
            loss = loss / num_microbatches

        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)

        new_residual = None
        if compress is not None:
            grads, new_residual = compress(grads, state["residual"])

        new_params, new_opt = optimizer.update(grads, state["opt"], params,
                                               state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_residual is not None:
            new_state["residual"] = new_residual
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return new_state, metrics

    return train_step
