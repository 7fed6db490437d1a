"""Streaming client on the PyTorch port: consume incremental
``RequestOutput`` deltas from ``Engine.submit`` handles.  The
counterpart of ``examples/streaming_client.py``.

Two consumption styles over one engine:

1. **Blocking iteration**: ``for delta in handle:`` drives engine ticks
   on demand until the request finishes (simplest for one request at a
   time).
2. **Poll-style multiplexing**: one ``eng.step()`` loop, draining every
   live handle's buffered deltas per tick (how a server multiplexes many
   concurrent streams; ``repro_torch.serving.http`` does it over HTTP).

Each request carries its own SamplingParams (greedy, seeded top-p,
stop-sequence); the seeded requests are reproducible token for token
across reruns.

With ``--trace-out FILE`` every request's lifecycle (queued wait,
prefill chunks, decode ticks) is exported as Chrome trace-event JSON.
With ``--spec-draft RATIO`` (e.g. ``1/8``) the engine decodes
self-speculatively: the streams are the same tokens either way, and the
exit line reports the accept rate.

Runs on the card by default, at full width; ``--device cpu --reduced``
runs a reduced model on the kernels' plain versions.

    PYTHONPATH=src python examples/streaming_client_torch.py \\
        [--device cpu --reduced] [--trace-out stream_trace.json] \\
        [--spec-draft 1/8 --spec-k 4]
"""
import argparse

import numpy as np

import repro_torch.configs as C
from repro_torch.configs.reduced import reduced
from repro_torch.models import build
from repro_torch.obs import Tracer
from repro_torch.serving import Engine, Request, SamplingParams


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--arch", default="qwen3-1.7b", choices=C.names())
    parser.add_argument("--hashed", action="store_true")
    parser.add_argument("--reduced", action="store_true")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--trace-out", default=None, metavar="FILE",
                        help="export per-request spans as Chrome "
                             "trace-event JSON (open in Perfetto)")
    parser.add_argument("--spec-draft", default=None, metavar="POLICY",
                        help="self-speculative decoding: draft policy JSON "
                             "or ratio ('1/8') derived off the served "
                             "weights; the tokens stay the same")
    parser.add_argument("--spec-k", type=int, default=4,
                        help="draft proposal depth (with --spec-draft)")
    args = parser.parse_args()

    cfg = C.get(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.hashed:
        cfg = cfg.hashed_variant(1 / 8)
    model = build(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)

    draft = None
    if args.spec_draft:
        from repro_torch.serving.draft import build_draft
        _, dmodel, dparams = build_draft(cfg, params, args.spec_draft)
        draft = (dmodel, dparams)

    tracer = Tracer(enabled=bool(args.trace_out))
    eng = Engine(model, params, device=args.device, max_concurrency=2,
                 max_len=128, eos_id=-1, prefix_cache=True, prefill_chunk=16,
                 tracer=tracer, draft=draft, spec_k=args.spec_k)

    # -- style 1: blocking iteration over one handle -----------------------
    prompt = rng.integers(2, cfg.vocab_size, 12).astype(np.int32)
    handle = eng.submit(Request(
        uid=0, prompt=prompt,
        sampling=SamplingParams(temperature=0.8, top_p=0.9, seed=42,
                                max_tokens=8, logprobs=2)))
    assert handle, "rejected?"
    print("== blocking iteration (seeded top-p, top-2 logprobs) ==")
    for delta in handle:
        pairs = "" if not delta.new_topk else \
            "  top2=" + str([[(t, round(lp, 2)) for t, lp in step]
                             for step in delta.new_topk])
        print(f"  += {delta.new_token_ids}{pairs}"
              + (f"  [{delta.finish_reason}]" if delta.done else ""))
    print(f"  total logprob {handle.req.cumulative_logprob:.3f}")

    # -- style 2: poll-style multiplexing ----------------------------------
    # learn greedy's opening tokens so a stop sequence provably triggers
    probe = eng.submit(Request(uid=99, prompt=prompt.copy(),
                               sampling=SamplingParams(max_tokens=2)))
    list(probe)                  # drive to completion
    stop_seq = tuple(probe.req.tokens)

    print("== multiplexed streams (greedy / seeded / stop-sequence) ==")
    specs = [
        ("greedy", SamplingParams(max_tokens=6)),
        ("seeded", SamplingParams(temperature=1.0, top_k=50, seed=7,
                                  max_tokens=6)),
        # greedy rerun with its own opening as the stop: ends early, "stop"
        ("stop", SamplingParams(max_tokens=6, stop=(stop_seq,))),
    ]
    handles = []
    for uid, (tag, sp) in enumerate(specs, start=1):
        h = eng.submit(Request(uid=uid, prompt=prompt.copy(), sampling=sp))
        assert h
        handles.append((tag, h))
    while eng.pending():
        eng.step()
        for tag, h in handles:
            for d in h.drain():
                print(f"  {tag:6s} += {d.new_token_ids}"
                      + (f"  [{d.finish_reason}]" if d.done else ""))
    stats = eng.stats()
    print("finish reasons:", stats["finish_reasons"])
    if "spec" in stats:
        sp = stats["spec"]
        print(f"spec decode: accept_rate={sp['accept_rate']:.3f} "
              f"mean_accept_len={sp['mean_accept_len']:.2f} (k={sp['k']})")
    if args.trace_out:
        tracer.export(args.trace_out)
        print(f"trace -> {args.trace_out} (open at https://ui.perfetto.dev)")


if __name__ == "__main__":
    main()
