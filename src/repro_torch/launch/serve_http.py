"""HTTP serving launcher of the PyTorch port: the asyncio front end over
one engine or a multi-model roster.

    # one model from config flags, on the card
    python -m repro_torch.launch.serve_http --arch qwen3-1.7b --hashed \\
        --port 8080

    # a catalog out of the sha256 registry (repeat --model-name)
    python -m repro_torch.launch.serve_http --registry runs/registry \\
        --model-name qwen3-dense --model-name qwen3-hashed@2 \\
        --quota qwen3-hashed=128 --port 8080

    curl -N -X POST localhost:8080/v1/completions -d \\
        '{"model":"qwen3-hashed","prompt":[12,7,99],"max_tokens":8,
          "stream":true}'

Runs on the card by default (``--device cuda``); ``--device cpu`` runs
every kernel's plain PyTorch version.  Weights from config flags are the
port's seeded init (``model.init(0)``); registry models carry their own.

SIGINT/SIGTERM drain gracefully: stop admitting (503), cancel queued
(terminal "cancelled" deltas), finish in-flight rows, print the final
metrics table, exit 0.  A second signal force-quits (exit 130).

``--self-test`` starts the server on an ephemeral port, runs one
streaming and one non-streaming completion against it, and checks both
are token-identical to driving an identically-seeded ``Engine``
directly — then exits 0, or 1 when they differ.
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
import sys

import numpy as np

import repro_torch.configs as C
from repro_torch import policy
from repro_torch.configs.reduced import reduced as reduce_cfg
from repro_torch.models import build
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.http import HTTPFrontend
from repro_torch.serving.http import client as http_client
from repro_torch.serving.multi_model import MultiModelEngine
from repro_torch.serving.scheduler import SchedulerConfig


def _parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None, choices=C.names())
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--hashed", action="store_true")
    p.add_argument("--compression", type=float, default=None)
    p.add_argument("--policy", default=None,
                   help="compression policy JSON (implies hashing)")
    p.add_argument("--budget", default=None,
                   help="equal-memory ratio ('1/8'; implies hashing)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--registry", default=None,
                   help="model registry root (with --model-name)")
    p.add_argument("--model-name", action="append", default=None,
                   metavar="NAME[@VER]",
                   help="registered model to host (repeatable; two or "
                        "more build a multi-model engine over one "
                        "shared page pool)")
    p.add_argument("--quota", action="append", default=None,
                   metavar="NAME=PAGES",
                   help="per-model page quota on the shared pool "
                        "(repeatable)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080,
                   help="0 picks an ephemeral port")
    p.add_argument("--max-concurrency", type=int, default=4)
    p.add_argument("--max-len", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=None)
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--scheduler", default="fifo",
                   choices=("fifo", "priority"))
    p.add_argument("--queue-limit", type=int, default=256)
    p.add_argument("--deadline", type=float, default=None,
                   help="queue deadline in seconds (maps to HTTP 504)")
    p.add_argument("--seed", type=int, default=0,
                   help="engine auto-seed stream")
    p.add_argument("--self-test", action="store_true",
                   help="serve on an ephemeral port, run one streaming + "
                        "one JSON completion, check token identity with "
                        "a direct Engine, exit 0 or 1")
    return p.parse_args(argv)


def _build_from_flags(args):
    cfg = C.get(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    if args.policy or args.budget:
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
    model = build(cfg, device=args.device)
    params = model.init(0)
    return cfg, model, params


def _sched_cfg(args) -> SchedulerConfig:
    return SchedulerConfig(policy=args.scheduler,
                           max_queue=args.queue_limit,
                           deadline_s=args.deadline)


def _quotas(args):
    out = {}
    for spec in args.quota or ():
        name, _, pages = spec.partition("=")
        if not pages.isdigit():
            raise SystemExit(f"bad --quota {spec!r} (want NAME=PAGES)")
        out[name] = int(pages)
    return out


def _make_engine(args):
    """Returns (engine, default_model_tag)."""
    if args.model_name:
        if not args.registry:
            raise SystemExit("--model-name requires --registry")
        mm = MultiModelEngine.from_registry(
            args.registry, args.model_name,
            quotas=_quotas(args),
            model_kwargs={
                tag.split("@", 1)[0]: dict(
                    slots=args.max_concurrency, max_len=args.max_len,
                    seed=args.seed, prefix_cache=args.prefix_cache)
                for tag in args.model_name},
            page_size=args.page_size, num_pages=args.num_pages,
            scheduler=_sched_cfg(args), device=args.device)
        return mm, mm.models()[0]
    if not args.arch:
        raise SystemExit("--arch or --registry/--model-name required")
    cfg, model, params = _build_from_flags(args)
    eng = Engine(model, params, device=args.device,
                 slots=args.max_concurrency,
                 max_len=args.max_len, eos_id=-1, seed=args.seed,
                 page_size=args.page_size, num_pages=args.num_pages,
                 prefix_cache=args.prefix_cache,
                 scheduler=_sched_cfg(args))
    return eng, cfg.name


async def _serve(args) -> int:
    eng, default_tag = _make_engine(args)
    fe = HTTPFrontend(eng, host=args.host, port=args.port,
                      default_model=default_tag)
    await fe.start()
    print(f"serving on http://{fe.host}:{fe.port}  "
          f"models={fe.model_names()}", flush=True)
    loop = asyncio.get_running_loop()
    sig_count = {"n": 0}

    def _on_signal():
        sig_count["n"] += 1
        if sig_count["n"] > 1:
            sys.exit(130)
        print("\ndraining: no new work, finishing in-flight rows "
              "(signal again to force-quit)", flush=True)
        fe.begin_drain()

    for s in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(s, _on_signal)
    await fe.wait_drained()
    await fe.aclose()
    print("--- metrics ---")
    print(fe.metrics.render(), flush=True)
    return 0


async def _self_test(args) -> int:
    """Start, hit the server both ways, pin identity vs direct Engine."""
    if not args.arch:
        raise SystemExit("--self-test needs --arch")
    cfg, model, params = _build_from_flags(args)
    mk = dict(device=args.device, slots=args.max_concurrency,
              max_len=args.max_len, eos_id=-1, seed=args.seed,
              page_size=args.page_size, prefix_cache=args.prefix_cache,
              scheduler=_sched_cfg(args))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size,
                            int(rng.integers(4, 16))).astype(np.int32)
               for _ in range(2)]
    sp = [SamplingParams(temperature=0.8, seed=11 + i, max_tokens=8)
          for i in range(2)]

    ref = Engine(model, params, **mk)
    for i, pr in enumerate(prompts):
        ref.submit(Request(uid=i, prompt=pr, sampling=sp[i]))
    ref.run()
    want = {r.uid: list(r.tokens) for r in ref._done}

    fe = HTTPFrontend(Engine(model, params, **mk), host=args.host,
                      port=0, default_model=cfg.name)
    await fe.start()
    host, port = fe.host, fe.port
    payloads = [dict(model=cfg.name, prompt=[int(t) for t in prompts[i]],
                     max_tokens=8, temperature=0.8, seed=11 + i)
                for i in range(2)]

    status, models = await http_client.request(host, port, "GET",
                                               "/v1/models")
    assert status == 200 and models["data"][0]["id"] == cfg.name, models
    status, body = await http_client.request(
        host, port, "POST", "/v1/completions", payloads[0])
    assert status == 200, (status, body)
    got_json = body["choices"][0]["token_ids"]
    streamed = await http_client.collect_stream(host, port, payloads[1])
    await fe.aclose()

    ok = got_json == want[0] and streamed["tokens"] == want[1]
    print(json.dumps({
        "self_test": "pass" if ok else "FAIL",
        "json_tokens": got_json, "stream_tokens": streamed["tokens"],
        "expected": {str(k): v for k, v in want.items()},
        "stream_ttft_s": streamed["ttft_s"]}), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    args = _parse_args(argv)
    if args.self_test:
        return asyncio.run(_self_test(args))
    return asyncio.run(_serve(args))


if __name__ == "__main__":
    raise SystemExit(main())
