"""Time the hashed GEMM, bank-gradient and top-k kernels of one checkout.

    python3 gemm_timing.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``)
and only its public kernel wrappers, so the same script times an older
checkout unpacked beside this one (``git archive``): run it on both
trees back to back on the same card, alternating (A, B, B, A), to
compare them.  Shapes: qwen3-1.7b-hashed8 at full width, ``attn.q``
(2048 x 2048) and ``ffn.out`` (6144 x 2048), element mode forward at
M = 1, 8, 256 and 1024 (each tree's default body: decode size runs the
gemv body where the tree has one), the element transpose (``dx``), the
block-mode forward and transpose (128 x 128 tiles) at M = 1024; the
element forward at M = 8 at ``attn.k`` (2048 x 1024) and ``ffn.up``
(2048 x 6144); the bank gradients of both modes (``element_dw``,
``block_dw``) at M = 1024 at ``attn.q``, ``attn.k`` and ``ffn.out``;
the sampler's top-k mask at B = 1, 8 and 64 rows of 151936 fp32 logits,
k = 50.  Each time is the
median over 20 launches of CUDA events around one wrapper call, the L2
flushed before each and the host ahead of the card (a device-side sleep
after the flush), so Python's launch cost is not counted.  With
``--split`` each case also reports its device time by kernel (the
decompression, the GEMM, the split-K reduction, the segment pass), from
``torch.profiler`` over 5 calls, the L2 flushed before each.  Prints the
card's name and power limit, then one JSON line per case.  Needs one
CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def timer(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def split(fn, flush, calls: int = 5) -> dict:
    """Device ms per call of each kernel ``fn`` launches (the flush's fill
    kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0][-48:]:
            e.self_device_time_total / calls / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and "FillFunctor" not in e.key}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parent
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--split", action="store_true",
                    help="also report each case's device time by kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import repro_torch.configs as C
    from repro_torch import policy
    from repro_torch.kernels import _build
    from repro_torch.kernels import hashed_matmul as THK
    from repro_torch.models.transformer import bank_spec_map

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _build.build(["hashed_matmul", "hashed_dw", "hashed_block", "topk"])
    from repro_torch.kernels.topk import topk_mask
    dev = torch.device("cuda")
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    specs = bank_spec_map(C.get("qwen3-1.7b-hashed8"))
    specs_b = bank_spec_map(C.get("qwen3-1.7b").policy_variant(
        policy.CompressionPolicy(mode="block", block_shape=(128, 128),
                                 path="pallas")))

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev) \
            .to(torch.bfloat16)

    for slot, path in (("q", ("layers", "attn", "q", "w")),
                       ("out", ("layers", "ffn", "out", "w"))):
        spec, spec_b = specs[path], specs_b[path]
        r, c = spec.rows, spec.cols
        w = randn(spec.num_buckets) * r ** -0.5
        wb = randn(*spec_b.real_param_shape()) * r ** -0.5
        cases = []
        for m in (1, 8, 256, 1024):
            x = randn(m, r)
            cases.append((f"element fwd {slot} M={m}",
                          lambda x=x: THK.element_matmul(x, w, spec)))
        x, gy = randn(1024, r), randn(1024, c)
        cases += [
            (f"element dx {slot} M=1024",
             lambda: THK.element_matmul_t(gy, w, spec)),
            (f"block fwd {slot} M=1024",
             lambda: THK.block_matmul(x, wb, spec_b)),
            (f"block transpose {slot} M=1024",
             lambda: THK.block_matmul(gy, wb, spec_b, transpose=True)),
        ]
        report(cases, args, flush)
    for slot, path in (("k", ("layers", "attn", "k", "w")),
                       ("up", ("layers", "ffn", "in", "w"))):
        spec = specs[path]
        w = randn(spec.num_buckets) * spec.rows ** -0.5
        x = randn(8, spec.rows)
        report([(f"element fwd {slot} M=8",
                 lambda: THK.element_matmul(x, w, spec))], args, flush)
    for slot in ("q", "k", "out"):
        path = {"q": ("layers", "attn", "q", "w"),
                "k": ("layers", "attn", "k", "w"),
                "out": ("layers", "ffn", "out", "w")}[slot]
        spec, spec_b = specs[path], specs_b[path]
        x, gy = randn(1024, spec.rows), randn(1024, spec.cols)
        report([(f"element dw {slot} M=1024",
                 lambda: THK.element_dw(x, gy, spec)),
                (f"block dw {slot} M=1024",
                 lambda: THK.block_dw(x, gy, spec_b))], args, flush)
    for b in (1, 8, 64):
        logits = torch.randn(b, 151936, generator=gen, device=dev)
        k50 = torch.full((b,), 50, dtype=torch.int32, device=dev)
        report([(f"topk B={b} k=50", lambda: topk_mask(logits, k50))], args,
               flush)
    return 0


def report(cases, args, flush) -> None:
    for name, fn in cases:
        row = {"label": args.label, "case": name, "ms": timer(fn, flush)}
        if args.split:
            row["device_ms_by_kernel"] = split(fn, flush)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
