"""Training runner of the PyTorch port: a decoder trained on the synthetic
LM stream on one device.

    python -m repro_torch.launch.train --arch qwen3-1.7b --hashed \\
        --steps 20 --batch 4 --seq 256

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
the hashed GEMM's plain PyTorch versions.  Hashed projections take the
hand-written kernels (forward, ``dx`` and ``dw``) unless a policy rule
names another path: ``--policy`` takes the JAX package's policy JSON,
e.g. ``{"mode": "block", "path": "pallas"}`` for block mode on the
kernels.  The same data (``lm_stream.batches(seed=17)``), warmup-cosine
AdamW and printed lines as the JAX package's ``launch/train.py``; its
mesh, checkpoint, fault-tolerance, gradient-compression and artifact
flags are not ported yet (ROADMAP Queue A items 5, 9, 12 and 13).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict

import torch

import repro_torch.configs as C
from repro_torch import policy
from repro_torch.configs.reduced import reduced as reduce_cfg
from repro_torch.core.device import resolve_device
from repro_torch.data import lm_stream
from repro_torch.models import build
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


def build_runner(cfg, device, *, optimizer_name="adamw", lr=3e-4,
                 num_microbatches=1, clip_norm=1.0, total_steps=10000):
    model = build(cfg, device=device)
    warmup = max(10, min(100, total_steps // 10))
    optimizer = opt_lib.make(optimizer_name,
                             opt_lib.warmup_cosine_lr(lr, warmup,
                                                      total_steps))
    train_step = step_lib.make_train_step(
        model, optimizer, num_microbatches=num_microbatches,
        clip_norm=clip_norm)
    return model, optimizer, train_step


def run(cfg, *, steps: int, batch: int, seq: int, num_microbatches: int = 1,
        log_every: int = 10, lr: float = 3e-4, device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    model, optimizer, train_step = build_runner(
        cfg, dev, num_microbatches=num_microbatches, lr=lr,
        total_steps=steps)
    state = step_lib.init_state(model, optimizer, seed=0)
    it = lm_stream.batches(seed=17, batch=batch, seq_len=seq,
                           vocab=cfg.vocab_size)
    losses = []
    for step_i in range(steps):
        t0 = time.perf_counter()
        arrays = next(it)
        tb = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        state, metrics = train_step(state, tb)
        loss = float(metrics["loss"])      # waits for the step
        losses.append(loss)
        if log_every and step_i % log_every == 0:
            print(f"step {step_i:5d} loss {loss:.4f} "
                  f"({time.perf_counter() - t0:.2f}s)", flush=True)
    return {"final_step": int(state["step"]), "losses": losses}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=C.names())
    p.add_argument("--reduced", action="store_true",
                   help="CPU-scale variant of the arch (same family)")
    p.add_argument("--hashed", action="store_true",
                   help="enable the paper's hashed weight sharing")
    p.add_argument("--compression", type=float, default=None,
                   help="uniform hashed compression ratio (default 0.125)")
    p.add_argument("--policy", default=None,
                   help="compression policy JSON (per-slot rules; implies "
                        "hashing)")
    p.add_argument("--budget", default=None,
                   help="equal-memory target: total real params as a "
                        "ratio of dense ('0.125' or '1/8'; implies hashing)")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    cfg = C.get(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.policy or args.budget:
        if args.hashed or args.compression is not None:
            p.error("--policy/--budget replace --hashed/--compression "
                    "(pin ratios with a policy rule instead)")
        pol = (policy.load(args.policy) if args.policy
               else policy.CompressionPolicy())
        if args.budget:
            pol = dataclasses.replace(
                pol, budget=policy.parse_ratio(args.budget))
        cfg = cfg.policy_variant(pol)
    elif args.hashed:
        cfg = cfg.hashed_variant(args.compression
                                 if args.compression is not None else 0.125)

    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              num_microbatches=args.microbatches, lr=args.lr,
              device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "losses"}))
    print(f"loss: first={out['losses'][0]:.4f} last={out['losses'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
