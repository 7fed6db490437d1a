"""Serving runner of the PyTorch port: the continuous-batching paged
engine (``repro_torch.serving.engine``).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --hashed \\
        --device cuda --requests 8 --max-new 16 \\
        --temperature 0.8 --top-p 0.9 --seed 0 --stream

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
every kernel's plain PyTorch version.  ``--attn-impl pallas`` (default)
and ``--hash-path pallas`` (default) select the hand-written kernels;
``ref`` / ``materialize`` / ``scan`` select plain PyTorch paths.  The
other flags are the JAX package's ``launch/serve.py`` ones:

- ``--ckpt-dir``: serve the params of the latest checkpoint there (a
  train state of either package's trainer: its ``['params']`` leaves,
  matched by key), else seeded random weights;
- sampling flags (``--temperature``/``--top-k``/``--top-p``/``--min-p``/
  ``--seed``/``--stop``/``--logprobs``) build one ``SamplingParams`` a
  request; ``--stream`` prints ``RequestOutput`` deltas as tokens land;
- the first SIGINT/SIGTERM drains: queued requests are cancelled,
  in-flight rows finish, and the metrics table prints; a second one
  exits with 130.

- ``--artifact FILE`` serves a compressed ``.hnart`` artifact, or
  ``--model-name NAME[@VERSION] --registry ROOT`` a registered one (its
  sha256 checked): the artifact carries its config and weights, so the
  config and checkpoint flags are refused beside it;
- ``--spec-draft 1/16`` (a ratio or a policy JSON) switches on
  self-speculative decoding with a draft derived off the served weights,
  ``--spec-k`` proposals a tick (``--spec-adaptive``: an accept-rate EWMA
  varies the depth within [1, k]); the emitted tokens are the
  non-speculative engine's, and an accept-rate line prints.

Meshes are not ported yet (ROADMAP Queue A item 12).  Prints per-request
generations, the finish reasons and one summary JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import signal
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
from repro_torch.train import checkpoint as ckpt_lib


def prompts(n: int, vocab: int):
    """The launcher's request prompts: ``n`` of 4 to 23 tokens, seeded."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        plen = int(rng.integers(4, 24))
        out.append(rng.integers(2, vocab, size=plen).astype(np.int32))
    return out


def load_params(model, ckpt_dir: str):
    """The params of the latest checkpoint in ``ckpt_dir``, or None when
    it holds none: the leaves under ``['params']`` of a saved train
    state, matched to the model's params by key (the optimizer state,
    whatever it holds, is not read)."""
    if ckpt_lib.latest_step(ckpt_dir) is None:
        return None
    return ckpt_lib.restore(ckpt_dir, model.empty_params(),
                            prefix="['params']")


class Drain:
    """The serve loop's SIGINT/SIGTERM handler: the first signal asks for
    a graceful drain (``requested``), a second one exits with 130."""

    def __init__(self):
        self.requested = False

    def __call__(self, signum, frame) -> None:
        if self.requested:
            raise SystemExit(130)
        self.requested = True
        print(f"\n[signal {signum}] draining: finishing in-flight rows, "
              "cancelling queued (signal again to force-quit)", flush=True)


def _print_deltas(handles, all_lp: bool = True) -> None:
    for h in handles:
        for d in h.drain():
            lp = "" if not (all_lp and d.new_logprobs) else \
                f"  lp={['%.3f' % v for v in d.new_logprobs]}"
            fin = f"  [{d.finish_reason}]" if d.done else ""
            print(f"req {d.uid} += {d.new_token_ids}{lp}{fin}")


def serve_loop(eng: Engine, handles, drain: Drain,
               stream: bool = False) -> None:
    """Tick the engine until it has no work.  Once ``drain.requested``,
    the queued requests are cancelled (their handles get terminal
    "cancelled" deltas) and the in-flight rows run to their end.  With
    ``stream`` every handle's new deltas print after each tick."""
    drained_queue = False
    while eng.pending():
        if drain.requested and not drained_queue:
            drained_queue = True
            n = len(eng.cancel_queued())
            if n:
                print(f"cancelled {n} queued request(s)")
        eng.step()
        if stream:
            _print_deltas(handles)
    if stream and drain.requested:
        # terminal deltas that landed after the last tick
        _print_deltas(handles, all_lp=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, choices=C.names(),
                   help="model config (not with --artifact/--model-name)")
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
    p.add_argument("--slots", type=int, default=None,
                   help="deprecated alias for --max-concurrency")
    p.add_argument("--max-concurrency", type=int, default=None,
                   help="decode batch width (default 4)")
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
    p.add_argument("--stop", action="append", default=None, metavar="IDS",
                   help="comma-separated token ids forming a stop sequence "
                        "(repeatable); generation finishes with reason "
                        "'stop' when the output ends with any of them")
    p.add_argument("--logprobs", type=int, default=None)
    p.add_argument("--stream", action="store_true",
                   help="print RequestOutput deltas as tokens land")
    p.add_argument("--ckpt-dir", default=None,
                   help="serve the params of the latest checkpoint here")
    p.add_argument("--artifact", default=None,
                   help="serve from a compressed model artifact file")
    p.add_argument("--model-name", default=None,
                   help="registered model name[@version] (with --registry)")
    p.add_argument("--registry", default=None,
                   help="model registry root for --model-name")
    p.add_argument("--spec-draft", default=None, metavar="POLICY",
                   help="self-speculative decoding: a compression ratio "
                        "('1/16') or policy JSON naming the draft derived "
                        "off the served weights; tokens stay the "
                        "non-speculative engine's")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft proposals per tick (k_max with "
                        "--spec-adaptive)")
    p.add_argument("--spec-adaptive", action="store_true",
                   help="vary the proposal depth within [1, --spec-k] "
                        "from an accept-rate EWMA")
    p.add_argument("--metrics-out", default=None, metavar="FILE")
    p.add_argument("--trace-out", default=None, metavar="FILE")
    p.add_argument("--debug-leak-check", action="store_true")
    args = p.parse_args(argv)
    if args.slots is not None and args.max_concurrency is not None:
        p.error("--slots is a deprecated alias for --max-concurrency; "
                "pass one, not both")
    concurrency = args.max_concurrency if args.max_concurrency is not None \
        else (args.slots if args.slots is not None else 4)

    if args.artifact and args.model_name:
        p.error("--artifact and --model-name are mutually exclusive")
    if args.artifact and args.registry:
        p.error("--registry goes with --model-name; a direct --artifact "
                "path bypasses registry integrity checks")
    if args.model_name and not args.registry:
        p.error("--model-name requires --registry")
    tracer = Tracer(enabled=bool(args.trace_out))
    engine_kwargs = dict(
        device=args.device, max_concurrency=concurrency,
        max_len=args.max_len, eos_id=-1, page_size=args.page_size,
        num_pages=args.num_pages, attn_impl=args.attn_impl,
        prefix_cache=args.prefix_cache, prefill_chunk=args.prefill_chunk,
        max_logprobs=max(8, args.logprobs or 0), tracer=tracer,
        debug_leak_check=args.debug_leak_check,
        spec_k=args.spec_k, spec_adaptive=args.spec_adaptive,
        scheduler=SchedulerConfig(policy=args.scheduler,
                                  max_queue=args.queue_limit,
                                  deadline_s=args.deadline))
    if args.artifact or args.model_name:
        # the artifact IS the model: config flags and checkpoints would be
        # silently ignored, so the combination is refused
        ignored = [flag for flag, on in [
            ("--arch", args.arch), ("--ckpt-dir", args.ckpt_dir),
            ("--hashed", args.hashed), ("--reduced", args.reduced),
            ("--compression", args.compression is not None),
            ("--policy", args.policy), ("--budget", args.budget)] if on]
        if ignored:
            p.error(f"{'/'.join(ignored)} cannot be combined with an "
                    f"artifact source (the artifact carries its own "
                    f"config and weights)")
        t_load = time.perf_counter()
        eng = Engine.from_artifact(
            args.artifact or args.model_name,
            registry_root=args.registry if args.model_name else None,
            draft_policy=args.spec_draft, **engine_kwargs)
        model, cfg = eng.model, eng.model.cfg
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        print(f"cold start from artifact: {cfg.name} "
              f"({time.perf_counter() - t_load:.2f}s to params-on-device)")
    else:
        if not args.arch:
            p.error("--arch is required without --artifact/--model-name")
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
                                     if args.compression is not None
                                     else 0.125)
        cfg = cfg.with_(hash_path=args.hash_path)

        model = build(cfg, device=args.device)
        params = None
        if args.ckpt_dir:
            t0 = time.perf_counter()
            params = load_params(model, args.ckpt_dir)
            if params is not None:
                print(f"loaded params from {args.ckpt_dir} "
                      f"({time.perf_counter() - t0:.2f}s)")
        if params is None:
            params = model.init(0)
        draft = None
        if args.spec_draft:
            from repro_torch.serving.draft import build_draft
            _, dmodel, dparams = build_draft(cfg, params, args.spec_draft)
            draft = (dmodel, dparams)
        eng = Engine(model, params, draft=draft, **engine_kwargs)
    stop = tuple(tuple(int(t) for t in ids.split(","))
                 for ids in (args.stop or ()))

    t0 = time.perf_counter()
    handles = []
    for uid, prompt in enumerate(prompts(args.requests, cfg.vocab_size)):
        sp = SamplingParams(
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p, min_p=args.min_p, stop=stop,
            max_tokens=args.max_new,
            seed=None if args.seed is None else args.seed + uid,
            logprobs=args.logprobs)
        h = eng.submit(Request(uid=uid, prompt=prompt, sampling=sp))
        if h:
            handles.append(h)
        else:
            print(f"req {uid}: REFUSED (queue full or can never fit the "
                  f"page pool)")
    drain = Drain()
    old_handlers = {sig: signal.signal(sig, drain)
                    for sig in (signal.SIGINT, signal.SIGTERM)}
    try:
        serve_loop(eng, handles, drain, stream=args.stream)
    finally:
        for sig, old in old_handlers.items():
            signal.signal(sig, old)
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    done = [h.req for h in handles if h.req.done]
    for r in sorted(done, key=lambda r: r.uid):
        print(f"req {r.uid}: {r.tokens}  (finish={r.finish_reason}, "
              f"seed={r.seed_used}, logprob={r.cumulative_logprob:.3f})")
    stats = eng.stats()
    print(f"finish reasons: {stats['finish_reasons']}  "
          f"sampler dispatches: {stats['sampler_dispatches']} "
          f"({stats['sampler_time_s']:.3f}s in sampler over "
          f"{stats['ticks']} ticks)")
    if "spec" in stats:
        sp = stats["spec"]
        print(f"spec decode: accept_rate={sp['accept_rate']:.3f} "
              f"mean_accept_len={sp['mean_accept_len']:.2f} "
              f"(k={sp['k']}, {sp['draft_dispatches']} draft / "
              f"{sp['verify_dispatches']} verify dispatches)")
    total = sum(len(r.tokens) for r in done)
    summary = {"requests": len(done), "tokens": total,
               "wall_s": round(dt, 3), "tok_per_s": round(total / dt, 1),
               "device": str(model.device)}
    summary.update(stats)
    print(json.dumps(summary))
    eng.shutdown()
    if eng.last_leak_error:
        print(f"LEAK CHECK FAILED:\n{eng.last_leak_error}")
    if args.metrics_out or drain.requested:
        # a drained run always prints the final table: the operator asked
        # the server to stop, not to discard its telemetry
        print("--- metrics ---")
        print(eng.metrics.render())
    if args.metrics_out:
        eng.metrics.export(args.metrics_out)
    if args.trace_out:
        tracer.export(args.trace_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
