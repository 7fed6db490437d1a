"""Paper-faithful training loop for the MLP experiments, PyTorch port of
the JAX package's ``paper/train.py``.

Chen et al. §6: SGD, minibatch 50, momentum, dropout, ReLU.  The same
fixed recipe as the JAX package (momentum 0.9, cosine-decayed LR, shared
across all methods), the same minibatch order
(``np.random.default_rng(seed).permutation`` per epoch) and the same
update ``mu = m * mu + g; p -= lr * mu``.  Steps run eagerly on the
device ``fit`` is given (the card by default): the hashed layers take
the hand-written kernels there.  Dropout masks and the initial params
come from ``torch.Generator``s; ``fit(params=...)`` starts from given
params instead (the tests carry the reference's across).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.paper import mlp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 30
    batch: int = 50                 # paper's minibatch size
    lr: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 0.0
    # dark knowledge
    distill_alpha: float = 0.5
    distill_temp: float = 4.0


def _lr_at(cfg: TrainConfig, step: int, total: int) -> float:
    prog = step / max(total, 1)
    return cfg.lr * (0.5 * (1 + np.cos(np.pi * prog)))


def _step(spec: mlp.MLPSpec, use_soft: bool, params, mu, x, y, soft,
          generator, lr: float, alpha: float, temp: float,
          momentum: float, fixed=None):
    """One SGD-momentum step; returns (params, mu, loss), all new
    tensors.  The scalars are rounded to fp32 first, as the JAX step
    takes them."""
    lr, alpha, temp, momentum = (float(np.float32(v))
                                 for v in (lr, alpha, temp, momentum))
    leaves = [{k: p[k].detach().requires_grad_(True) for k in sorted(p)}
              for p in params]
    logits = mlp.apply(spec, leaves, x, generator=generator, train=True,
                       fixed=fixed)
    if use_soft:
        loss = mlp.distill_loss(logits, y, soft, alpha, temp)
    else:
        loss = mlp.xent(logits, y)
    flat = [p[k] for p in leaves for k in sorted(p)]
    grads = iter(torch.autograd.grad(loss, flat))
    new_params, new_mu = [], []
    with torch.no_grad():
        for p, m in zip(leaves, mu):
            mp, mm = {}, {}
            for k in sorted(p):
                mm[k] = momentum * m[k] + next(grads)
                mp[k] = p[k].detach() - lr * mm[k]
            new_params.append(mp)
            new_mu.append(mm)
    return new_params, new_mu, loss.detach()


def _device_of(params) -> torch.device:
    return params[0]["b"].device


def _eval_logits(spec, params, x: np.ndarray, fixed) -> torch.Tensor:
    with torch.no_grad():
        return mlp.apply(spec, params,
                         torch.from_numpy(x).to(_device_of(params)),
                         train=False, fixed=fixed)


def evaluate(spec: mlp.MLPSpec, params, x: np.ndarray, y: np.ndarray,
             batch: int = 2000, fixed=None) -> float:
    """Test error rate in [0, 1]."""
    wrong = 0
    for i in range(0, len(x), batch):
        logits = _eval_logits(spec, params, x[i:i + batch], fixed)
        wrong += int(np.sum(logits.argmax(-1).cpu().numpy()
                            != y[i:i + batch]))
    return wrong / len(x)


def soft_targets(spec: mlp.MLPSpec, params, x: np.ndarray,
                 temperature: float, batch: int = 2000,
                 fixed=None) -> np.ndarray:
    """Teacher's softened softmax over the training set (DK targets)."""
    outs = []
    for i in range(0, len(x), batch):
        logits = _eval_logits(spec, params, x[i:i + batch], fixed)
        outs.append(torch.softmax(logits.float() / temperature, dim=-1)
                    .cpu().numpy())
    return np.concatenate(outs)


def fit(spec: mlp.MLPSpec, x: np.ndarray, y: np.ndarray,
        cfg: TrainConfig = TrainConfig(), seed: int = 0,
        soft: Optional[np.ndarray] = None,
        x_test: Optional[np.ndarray] = None,
        y_test: Optional[np.ndarray] = None,
        log_every: int = 0, params: Optional[List[dict]] = None,
        fixed=None, device=None) -> Tuple[list, Dict]:
    """Train on ``device`` (default the card); returns (params, history).

    history: "loss" (each epoch's last minibatch loss, as the JAX
    package records), "mean_loss" (each epoch's mean), "test_err" (every
    ``log_every`` epochs) and, on the card, "step_ms" (each step's
    CUDA-event time)."""
    dev = resolve_device(device)
    if params is None:
        params = mlp.init(spec, torch.Generator().manual_seed(seed), dev)
    else:
        params = [{k: v.to(dev) for k, v in p.items()} for p in params]
    if fixed is None:
        fixed = mlp.fixed_factors(spec, dev)
    mu = [{k: torch.zeros_like(v) for k, v in p.items()} for p in params]
    drop_gen = torch.Generator(device=dev).manual_seed(seed)

    n = len(x)
    steps_per_epoch = max(1, n // cfg.batch)
    total = cfg.epochs * steps_per_epoch
    rng = np.random.default_rng(seed)
    use_soft = soft is not None
    if not use_soft:
        soft = np.zeros((n, int(y.max()) + 1), np.float32)
    xs = torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    ys = torch.from_numpy(np.asarray(y)).to(dev)
    softs = torch.from_numpy(np.asarray(soft, np.float32)).to(dev)

    hist = {"loss": [], "mean_loss": [], "test_err": []}
    events = []
    step = 0
    for epoch in range(cfg.epochs):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        loss_sum = torch.zeros((), device=dev)
        for i in range(steps_per_epoch):
            idx = perm[i * cfg.batch:(i + 1) * cfg.batch]
            if dev.type == "cuda":
                events.append((torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True)))
                events[-1][0].record()
            params, mu, loss = _step(
                spec, use_soft, params, mu, xs[idx], ys[idx], softs[idx],
                drop_gen, _lr_at(cfg, step, total), cfg.distill_alpha,
                cfg.distill_temp, cfg.momentum, fixed)
            if events:
                events[-1][1].record()
            loss_sum += loss
            step += 1
        hist["loss"].append(float(loss))
        hist["mean_loss"].append(float(loss_sum) / steps_per_epoch)
        if log_every and (epoch + 1) % log_every == 0 and x_test is not None:
            err = evaluate(spec, params, x_test, y_test, fixed=fixed)
            hist["test_err"].append(err)
            print(f"  epoch {epoch+1:3d} loss {float(loss):.4f} "
                  f"test_err {err*100:.2f}%", flush=True)
    if events:
        torch.cuda.synchronize()
        hist["step_ms"] = [s.elapsed_time(e) for s, e in events]
    return params, hist


def run_method(method: str, dims, compression: float,
               x, y, x_test, y_test, cfg: TrainConfig = TrainConfig(),
               seed: int = 0, teacher=None, device=None) -> Dict:
    """One (method, compression) cell of the paper's tables, trained on
    ``device`` (default the card).

    method in {hashed, hashed_dk, nn, dk, rer, lrd}; `teacher` is
    (spec, params) of the compression-1 dense net for the *_dk variants.
    Besides the JAX package's keys, the result holds the fit's
    ``history``.
    """
    base = dict(dropout=0.3, input_dropout=0.1, seed=seed)
    soft = None
    if method in ("nn", "dk"):
        eq_dims = mlp.equivalent_dense_dims(dims, compression)
        spec = mlp.MLPSpec(eq_dims, method="dense", **base)
    elif method in ("hashed", "hashed_dk"):
        spec = mlp.MLPSpec(tuple(dims), method="hashed",
                           compression=compression, **base)
    elif method == "rer":
        spec = mlp.MLPSpec(tuple(dims), method="rer",
                           compression=compression, **base)
    elif method == "lrd":
        spec = mlp.MLPSpec(tuple(dims), method="lrd",
                           compression=compression, **base)
    else:
        raise ValueError(method)

    if method in ("dk", "hashed_dk"):
        if teacher is None:
            raise ValueError("DK needs a compression-1 teacher")
        tspec, tparams = teacher
        soft = soft_targets(tspec, tparams, x, cfg.distill_temp)

    params, hist = fit(spec, x, y, cfg=cfg, seed=seed, soft=soft,
                       device=device)
    err = evaluate(spec, params, x_test, y_test)
    return {"method": method, "compression": compression,
            "test_err": err, "free_params": spec.free_params(),
            "dims": spec.dims, "history": hist}
