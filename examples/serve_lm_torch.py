"""Serve a model with batched requests through the PyTorch port's
continuous-batching engine: mixed prompt lengths, interleaved
admissions, per-row cache positions, greedy + sampled generation.  The
counterpart of ``examples/serve_lm.py``.

Runs on the card by default, at full width; ``--device cpu --reduced``
runs a reduced model on the kernels' plain versions.

    PYTHONPATH=src python examples/serve_lm_torch.py [--hashed]
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --reduced
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.configs.reduced import reduced
from repro_torch.models import build
from repro_torch.serving.engine import Engine, Request


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="qwen3-1.7b", choices=C.names())
    parser.add_argument("--hashed", action="store_true")
    parser.add_argument("--reduced", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--requests", type=int, default=10)
    parser.add_argument("--slots", type=int, default=4)
    args = parser.parse_args()

    cfg = C.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.hashed:
        cfg = cfg.hashed_variant(1 / 8)
    model = build(cfg, device=args.device)
    params = model.init(0)

    rng = np.random.default_rng(0)
    engine = Engine(model, params, device=args.device, slots=args.slots,
                    max_len=128, eos_id=-1)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        plen = int(rng.integers(3, 20))
        engine.submit(Request(
            uid=uid,
            prompt=rng.integers(2, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(4, 12)),
            temperature=0.0 if uid % 2 == 0 else 0.8))
    done = engine.run()
    if args.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in done)
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid:2d} ({len(r.prompt):2d}-token prompt) "
              f"-> {r.tokens}")
    where = torch.cuda.get_device_name(0) if args.device == "cuda" \
        else "cpu"
    print(f"\n{len(done)} requests, {total} tokens, {dt:.1f}s "
          f"({total / dt:.1f} tok/s) on {args.slots} slots "
          f"[{cfg.name}, {where}]")
    assert len(done) == args.requests


if __name__ == "__main__":
    main()
