"""Serving runner of the PyTorch port: the continuous-batching paged
engine (``repro_torch.serving.engine``) on seeded random weights.

    python -m repro_torch.launch.serve --arch qwen3-1.7b --hashed \\
        --device cuda --requests 8 --max-new 16

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
every kernel's plain PyTorch version.  ``--attn-impl pallas`` (default)
and ``--hash-path pallas`` (default) select the hand-written kernels;
``ref`` / ``materialize`` / ``scan`` select plain PyTorch paths.  The
flags that apply keep the JAX package's ``launch/serve.py`` names;
artifacts, checkpoints, speculative decoding and meshes are not ported
yet.  Prints per-request generations and one summary JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import policy
from repro_torch.configs.reduced import reduced as reduce_cfg
from repro_torch.models import build
from repro_torch.obs import Tracer
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.scheduler import SchedulerConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True, choices=C.names())
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--hashed", action="store_true")
    p.add_argument("--compression", type=float, default=None,
                   help="hashed compression ratio (default 0.125)")
    p.add_argument("--policy", default=None,
                   help="compression policy JSON (implies hashing)")
    p.add_argument("--budget", default=None,
                   help="equal-memory real-param target ratio "
                        "('0.125' or '1/8'; implies hashing)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--max-concurrency", type=int, default=4)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--scheduler", default="fifo",
                   choices=("fifo", "priority"))
    p.add_argument("--queue-limit", type=int, default=256)
    p.add_argument("--deadline", type=float, default=None)
    p.add_argument("--attn-impl", default="pallas", choices=("ref", "pallas"),
                   help="paged attention: the CUDA kernels (pallas) or "
                        "their plain PyTorch versions (ref)")
    p.add_argument("--hash-path", default="pallas",
                   choices=("materialize", "scan", "pallas"),
                   help="hashed projections: the fused CUDA kernel "
                        "(pallas) or a plain PyTorch path")
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--max-new", type=int, default=16)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--min-p", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=None,
                   help="base sampling seed; request uid offsets it")
    p.add_argument("--logprobs", type=int, default=None)
    p.add_argument("--metrics-out", default=None, metavar="FILE")
    p.add_argument("--trace-out", default=None, metavar="FILE")
    p.add_argument("--debug-leak-check", action="store_true")
    args = p.parse_args(argv)

    cfg = C.get(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.policy or args.budget:
        if args.hashed or args.compression is not None:
            p.error("--policy/--budget replace --hashed/--compression")
        pol = (policy.load(args.policy) if args.policy
               else policy.CompressionPolicy())
        if args.budget:
            pol = dataclasses.replace(
                pol, budget=policy.parse_ratio(args.budget))
        cfg = cfg.policy_variant(pol)
    elif args.hashed:
        cfg = cfg.hashed_variant(args.compression
                                 if args.compression is not None else 0.125)
    cfg = cfg.with_(hash_path=args.hash_path)

    model = build(cfg, device=args.device)
    params = model.init(0)
    tracer = Tracer(enabled=bool(args.trace_out))
    eng = Engine(model, params, device=args.device,
                 max_concurrency=args.max_concurrency, max_len=args.max_len,
                 eos_id=-1, page_size=args.page_size,
                 num_pages=args.num_pages, attn_impl=args.attn_impl,
                 prefix_cache=args.prefix_cache,
                 prefill_chunk=args.prefill_chunk,
                 max_logprobs=max(8, args.logprobs or 0), tracer=tracer,
                 debug_leak_check=args.debug_leak_check,
                 scheduler=SchedulerConfig(policy=args.scheduler,
                                           max_queue=args.queue_limit,
                                           deadline_s=args.deadline))

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = []
    for uid in range(args.requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32)
        sp = SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, min_p=args.min_p, max_tokens=args.max_new,
            seed=None if args.seed is None else args.seed + uid,
            logprobs=args.logprobs)
        h = eng.submit(Request(uid=uid, prompt=prompt, sampling=sp))
        if h:
            handles.append(h)
        else:
            print(f"req {uid}: REFUSED (queue full or can never fit the "
                  f"page pool)")
    eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    done = [h.req for h in handles if h.req.done]
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {r.tokens}  (finish={r.finish_reason}, "
              f"seed={r.seed_used}, logprob={r.cumulative_logprob:.3f})")
    total = sum(len(r.tokens) for r in done)
    summary = {"requests": len(done), "tokens": total,
               "wall_s": round(dt, 3), "tok_per_s": round(total / dt, 1),
               "device": str(model.device)}
    summary.update(eng.stats())
    print(json.dumps(summary))
    eng.shutdown()
    if eng.last_leak_error:
        print(f"LEAK CHECK FAILED:\n{eng.last_leak_error}")
    if args.metrics_out:
        eng.metrics.export(args.metrics_out)
    if args.trace_out:
        tracer.export(args.trace_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
