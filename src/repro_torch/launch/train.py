"""Training runner of the PyTorch port: a decoder trained on the synthetic
LM stream on one device, with checkpoint/restart, fault tolerance and
gradient compression.

    python -m repro_torch.launch.train --arch qwen3-1.7b --hashed \\
        --steps 20 --batch 4 --seq 256 --ckpt-dir run1 --ckpt-every 10

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
the hashed GEMM's plain PyTorch versions.  Hashed projections take the
hand-written kernels (forward, ``dx`` and ``dw``) unless a policy rule
names another path: ``--policy`` takes the JAX package's policy JSON,
e.g. ``{"mode": "block", "path": "pallas"}`` for block mode on the
kernels.  The same data (``lm_stream.batches(seed=17)``), warmup-cosine
AdamW and printed lines as the JAX package's ``launch/train.py``:

- ``--ckpt-dir``: restore the latest committed checkpoint there and
  resume at its step (the data stream too), save every ``--ckpt-every``
  steps and at the end (``train/checkpoint.py``, the JAX package's
  format);
- ``PreemptionGuard`` over init, restore and the loop: SIGTERM ends the
  run after the current step with an emergency checkpoint and exit 0;
- a heartbeat file (``--ckpt-dir``/heartbeat.json, or
  ``heartbeat_path``) per step, and ``StepTimer`` straggler flags;
- ``--grad-compress hashed_space|int8``: compressed gradients with error
  feedback (``train/grad_compress.py``);
- ``--artifact-dir`` (needs ``--ckpt-dir``): export a compressed
  ``.hnart`` artifact at every committed checkpoint
  (``checkpoint.artifact_exporter``), ``--artifact-quant int8|fp8`` its
  bank quantization, ``--registry`` registers each export under the
  config's name.

Not ported: the mesh (ROADMAP Queue A item 12).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import torch

import repro_torch.configs as C
from repro_torch import policy
from repro_torch.configs.reduced import reduced as reduce_cfg
from repro_torch.core.device import resolve_device
from repro_torch.data import lm_stream
from repro_torch.models import build
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import optimizer as opt_lib
from repro_torch.train import step as step_lib


def build_runner(cfg, device, *, optimizer_name="adamw", lr=3e-4,
                 num_microbatches=1, clip_norm=1.0, total_steps=10000,
                 grad_compressor=None, compress_ratio=0.125):
    model = build(cfg, device=device)
    warmup = max(10, min(100, total_steps // 10))
    optimizer = opt_lib.make(optimizer_name,
                             opt_lib.warmup_cosine_lr(lr, warmup,
                                                      total_steps))
    train_step = step_lib.make_train_step(
        model, optimizer, num_microbatches=num_microbatches,
        clip_norm=clip_norm, grad_compressor=grad_compressor,
        compress_ratio=compress_ratio)
    return model, optimizer, train_step


def run(cfg, *, steps: int, batch: int, seq: int,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
        ckpt_keep: int = 3, num_microbatches: int = 1, log_every: int = 10,
        heartbeat_path: Optional[str] = None, lr: float = 3e-4,
        grad_compressor: Optional[str] = None,
        artifact_dir: Optional[str] = None,
        registry_root: Optional[str] = None,
        device=None) -> Dict[str, Any]:
    """Train ``cfg`` to ``steps`` steps on ``device`` (default the card),
    resuming from ``ckpt_dir``'s latest checkpoint if it has one and
    keeping its newest ``ckpt_keep`` checkpoints; with ``artifact_dir``
    each committed checkpoint also exports an artifact (registered in
    ``registry_root`` when given).  Returns
    {"final_step", "losses" (of the steps this call ran), "step_times"
    (seconds, host clock, each ending in the loss's read),
    "straggler_count", "save_seconds" (each checkpoint's),
    "restore_seconds" (None without a restore), "state" (the final train
    state)}."""
    dev = resolve_device(device)
    model, optimizer, train_step = build_runner(
        cfg, dev, num_microbatches=num_microbatches, lr=lr,
        total_steps=steps, grad_compressor=grad_compressor)
    with_residual = grad_compressor is not None

    # the guard covers init/restore too: a preemption signal during the
    # first steps' kernel builds must not hard-kill the job
    guard_cm = ft.PreemptionGuard()
    guard = guard_cm.__enter__()
    try:
        state = step_lib.init_state(model, optimizer, seed=0,
                                    with_residual=with_residual)
        start_step, restore_s, save_s = 0, None, []
        if ckpt_dir and ckpt_lib.latest_step(ckpt_dir) is not None:
            t0 = time.perf_counter()
            state = ckpt_lib.restore(ckpt_dir, state)
            restore_s = time.perf_counter() - t0
            start_step = int(state["step"])
            print(f"restored checkpoint @ step {start_step}", flush=True)

        export_hook = None
        if artifact_dir:
            export_hook = ckpt_lib.artifact_exporter(
                cfg, artifact_dir, registry_root=registry_root)
        if heartbeat_path is None and ckpt_dir:
            heartbeat_path = os.path.join(ckpt_dir, "heartbeat.json")
        hb = ft.Heartbeat(heartbeat_path) if heartbeat_path else None
        timer = ft.StepTimer()
        it = lm_stream.batches(seed=17, batch=batch, seq_len=seq,
                               vocab=cfg.vocab_size, start_step=start_step)
        losses, times = [], []
        for step_i in range(start_step, steps):
            timer.start()
            arrays = next(it)
            tb = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
            state, metrics = train_step(state, tb)
            loss = float(metrics["loss"])      # waits for the step
            losses.append(loss)
            t = timer.stop()
            times.append(t["step_time"])
            if hb is not None:
                hb.beat(step_i, loss=loss)
            if log_every and step_i % log_every == 0:
                print(f"step {step_i:5d} loss {loss:.4f} "
                      f"({t['step_time']:.2f}s"
                      f"{' STRAGGLER' if t['straggler'] else ''})",
                      flush=True)
            if ckpt_dir and ((step_i + 1) % ckpt_every == 0
                             or guard.should_stop or step_i + 1 == steps):
                t0 = time.perf_counter()
                ckpt_lib.save(state, ckpt_dir, step_i + 1, keep=ckpt_keep,
                              on_save=export_hook)
                save_s.append(time.perf_counter() - t0)
            if guard.should_stop:
                print("preemption: emergency checkpoint saved, "
                      "exiting cleanly", flush=True)
                break
    finally:
        guard_cm.__exit__(None, None, None)
    return {"final_step": int(state["step"]), "losses": losses,
            "step_times": times, "straggler_count": timer.stragglers,
            "save_seconds": save_s, "restore_seconds": restore_s,
            "state": state}


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
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--grad-compress", default=None,
                   choices=["hashed_space", "int8"],
                   help="gradient compression with error feedback")
    p.add_argument("--artifact-dir", default=None,
                   help="export a compressed model artifact alongside "
                        "every committed checkpoint")
    p.add_argument("--artifact-quant", default="none",
                   choices=["none", "int8", "fp8"],
                   help="bank quantization for exported artifacts")
    p.add_argument("--registry", default=None,
                   help="model registry root; exported artifacts are "
                        "registered under the config name")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if (args.artifact_quant != "none" or args.registry) \
            and not args.artifact_dir:
        p.error("--artifact-quant/--registry require --artifact-dir")
    if args.artifact_dir and not args.ckpt_dir:
        p.error("--artifact-dir requires --ckpt-dir (artifacts are "
                "exported at checkpoint commits)")

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
    if args.artifact_quant != "none":
        cfg = cfg.with_(artifact_quant=args.artifact_quant)

    out = run(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
              num_microbatches=args.microbatches, lr=args.lr,
              grad_compressor=args.grad_compress,
              artifact_dir=args.artifact_dir, registry_root=args.registry,
              device=args.device)
    print(json.dumps({"final_step": out["final_step"],
                      "straggler_count": out["straggler_count"]}))
    if out["losses"]:
        print(f"loss: first={out['losses'][0]:.4f} "
              f"last={out['losses'][-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
