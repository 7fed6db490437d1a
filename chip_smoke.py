"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports ``repro_torch`` from ``src/``
and nothing of JAX or the JAX package.  Phases, each failing the script:

1. the card's name and power limit (``nvidia-smi``) and torch's version;
2. build every CUDA kernel of the serving path from ``src/`` (one
   ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card at the
   full-width qwen3-1.7b-hashed8 shapes, and time kernel, plain version
   and a PyTorch library yardstick with CUDA events (median of 20, the
   L2 flushed before each launch);
4. serve qwen3-1.7b-hashed8 at full width (28 layers, bf16, seeded
   weights) through the paged engine: 8 requests, every kernel's launch
   count > 0 and no plain version run on the card; then one decode step
   on the kernel path against the plain path.

Prints a JSON line of per-kernel numbers, then as its last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL_BF16 = 1e-2                # max |kernel - plain| / max |plain|, bf16
TOL_LOGITS = 5e-2              # whole-model logits, 28 bf16 layers


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, the L2
    flushed before each (the serving path finds each layer's bank and
    pages cold: a decode step touches ~350 MB of banks)."""

    def __init__(self, dev):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    err = (got.float() - ref.float()).abs().max().item()
    scale = max(ref.float().abs().max().item(), 1e-30)
    return err, err / scale


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import repro_torch.configs as C
    from repro_torch import kernels as K
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_prefill import (paged_prefill_attention,
                                                   paged_prefill_ref)
    from repro_torch.kernels.hashed_matmul import hashed_matmul_ref
    from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                     paged_decode_attention)
    from repro_torch.kernels.topk import topk_mask, topk_mask_ref
    from repro_torch.core import hashed as H
    from repro_torch.models import build
    from repro_torch.models.transformer import bank_spec_map
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.scheduler import SchedulerConfig
    import torch.nn.functional as F

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"[1] card: {card}  torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build()
    print(f"[2] built {len(secs)} kernels in "
          f"{time.perf_counter() - t0:.1f}s wall: "
          + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()), flush=True)
    for name in _build.NAMES:
        for line in _build.ptxas_report(name).splitlines():
            print(f"    ptxas {name}: {line.strip()}")

    cfg = C.get("qwen3-1.7b-hashed8").with_(hash_path="pallas")
    specs = bank_spec_map(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    results = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- 3a. hashed GEMM -------------------------------------------------------
    print("[3] kernels against their plain versions on the card", flush=True)
    for slot in ("q", "out"):
        path = ("layers", "attn", "q", "w") if slot == "q" \
            else ("layers", "ffn", "out", "w")
        spec = specs[path]
        w = randn(spec.num_buckets) * (1.0 / spec.rows ** 0.5)
        v_dense = H.materialize(w, spec, dtype=torch.bfloat16)
        for m in (1, 8, 256):
            x = randn(m, spec.rows)
            got = ops.hashed_matmul(x, w, spec)
            ref = hashed_matmul_ref(x, w, spec)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            ok = rel <= TOL_BF16
            ms = timer(lambda: ops.hashed_matmul(x, w, spec))
            plain = timer(lambda: hashed_matmul_ref(x, w, spec))
            lib = timer(lambda: torch.matmul(x, v_dense))
            nbytes = 2 * (m * spec.rows + spec.num_buckets + m * spec.cols)
            b, by = bound_ms(nbytes, 2.0 * m * spec.rows * spec.cols,
                             BF16_FLOPS)
            key = f"hashed_matmul {slot} M={m}"
            print(f"    {key}: {spec.rows}x{spec.cols} Kp="
                  f"{spec.buckets_per_panel} max_abs_err={err:.3e} "
                  f"rel={rel:.2e} (tol {TOL_BF16}) {'ok' if ok else 'FAIL'}"
                  f"  ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f}"
                  f" bound_ms={b:.5f} ({by})", flush=True)
            if not ok:
                fail(f"{key} disagrees with its plain version")
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=b, bound_by=by)

    # -- 3b. paged decode ------------------------------------------------------
    nkv, hq, hd, ps = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    g = hq // nkv
    maxp, npages = 16, 8 * 16 + 1
    pk = randn(npages, ps, nkv, hd)
    pv = randn(npages, ps, nkv, hd)
    perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
    table = perm[: 8 * maxp].reshape(8, maxp).to(torch.int32)
    lengths = torch.tensor([0, 1, 17, 64, 100, 200, 255, 256],
                           dtype=torch.int32, device=dev)
    table[0] = 0                                   # idle row: trash page
    q = randn(8, hq, hd)
    for window in (0, 48):
        got = paged_decode_attention(q, pk, pv, table, lengths, window)
        ref = paged_attention_ref(q, pk, pv, table, lengths, window)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        zero_row = got[0].abs().max().item() == 0.0
        ok = rel <= TOL_BF16 and zero_row
        print(f"    paged_decode B=8 window={window}: max_abs_err={err:.3e} "
              f"rel={rel:.2e} (tol {TOL_BF16}) length-0 row zero={zero_row}"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("paged_decode disagrees with its plain version")
    ms = timer(lambda: paged_decode_attention(q, pk, pv, table, lengths))
    plain = timer(lambda: paged_attention_ref(q, pk, pv, table, lengths))
    # the yardstick gets K/V gathered by the table and repeated over each
    # kv head's query group, outside the timed call
    kg = pk[table.long()].reshape(8, maxp * ps, nkv, hd).transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    vg = pv[table.long()].reshape(8, maxp * ps, nkv, hd).transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    kv_pos = torch.arange(maxp * ps, device=dev)
    mask = (kv_pos[None, :] < lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]
    lib = timer(lambda: F.scaled_dot_product_attention(
        q4, kg, vg, attn_mask=mask))
    live = int(lengths.sum())
    nbytes = 2 * (2 * q.numel()) + live * nkv * hd * 2 * 2 + table.numel() * 4
    b, by = bound_ms(nbytes, 4.0 * live * hq * hd, BF16_FLOPS)
    print(f"    paged_decode B=8 ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={b:.5f} ({by})", flush=True)
    results["paged_decode"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                   library_ms=lib, bound_ms=b, bound_by=by)

    # -- 3c. ragged prefill ----------------------------------------------------
    S = 128
    starts = torch.tensor([32, 0, 100, 17], dtype=torch.int32, device=dev)
    counts = torch.tensor([128, 0, 90, 37], dtype=torch.int32, device=dev)
    ptable = table[4:8].clone()
    ptable[0, :2] = table[1, :2]        # row 0 reads a prefix row 1 owns
    qp = randn(4, S, hq, hd)
    for window in (0, 40):
        got = paged_prefill_attention(qp, pk, pv, ptable, starts, counts,
                                      window)
        ref = paged_prefill_ref(qp, pk, pv, ptable, starts, counts, window)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        pad_zero = got[1].abs().max().item() == 0.0 \
            and got[2, 90:].abs().max().item() == 0.0
        ok = rel <= TOL_BF16 and pad_zero
        print(f"    paged_prefill B=4 S={S} window={window}: "
              f"max_abs_err={err:.3e} rel={rel:.2e} (tol {TOL_BF16}) "
              f"pad/count-0 zero={pad_zero} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("paged_prefill disagrees with its plain version")
    ms = timer(lambda: paged_prefill_attention(qp, pk, pv, ptable, starts,
                                               counts))
    plain = timer(lambda: paged_prefill_ref(qp, pk, pv, ptable, starts,
                                            counts))
    kgp = pk[ptable.long()].reshape(4, maxp * ps, nkv, hd).transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    vgp = pv[ptable.long()].reshape(4, maxp * ps, nkv, hd).transpose(1, 2) \
        .repeat_interleave(g, dim=1)
    qpos = starts[:, None] + torch.arange(S, device=dev)[None, :]
    pmask = (kv_pos[None, None, :] <= qpos[:, :, None]) \
        & (kv_pos[None, None, :] < (starts + counts)[:, None, None])
    pmask = pmask[:, None]
    qt = qp.transpose(1, 2)
    lib = timer(lambda: F.scaled_dot_product_attention(
        qt, kgp, vgp, attn_mask=pmask))
    st_l, cn_l = starts.tolist(), counts.tolist()
    visible = sum(st + s + 1 for st, c in zip(st_l, cn_l) for s in range(c))
    kv_bytes = sum(st + c for st, c in zip(st_l, cn_l)) * nkv * hd * 2 * 2
    nbytes = 2 * 2 * qp.numel() + kv_bytes + ptable.numel() * 4
    b, by = bound_ms(nbytes, 4.0 * visible * hq * hd, BF16_FLOPS)
    print(f"    paged_prefill B=4 S={S} ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={b:.5f} ({by})", flush=True)
    results["paged_prefill"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                    library_ms=lib, bound_ms=b, bound_by=by)

    # -- 3d. top-k -------------------------------------------------------------
    V = cfg.vocab_size
    logits = torch.randn(8, V, generator=gen, device=dev)
    logits[2, :100] = 3.5                      # ties at the threshold
    logits[3, ::2] = 0.0                       # +-0.0 at the threshold
    logits[3, 1::2] = -0.0
    logits[3, :10] = 1.0
    kvec = torch.tensor([0, 1, 50, 50, V, 20, 50, 7], dtype=torch.int32,
                        device=dev)
    got = topk_mask(logits, kvec)
    ref = topk_mask_ref(logits, kvec)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, ref))
    err = (got - ref).abs().max().item()
    print(f"    topk_mask B=8 V={V} k={kvec.tolist()}: bitwise equal={same} "
          f"(tol 0: survivors pass through) {'ok' if same else 'FAIL'}",
          flush=True)
    if not same:
        fail("topk_mask disagrees with its plain version")
    k50 = torch.full((8,), 50, dtype=torch.int32, device=dev)
    ms = timer(lambda: topk_mask(logits, k50))
    plain = timer(lambda: topk_mask_ref(logits, k50))
    lib = timer(lambda: torch.topk(logits, 50, dim=-1))
    b, by = bound_ms(2 * logits.numel() * 4, 0.0, FP32_FLOPS)
    print(f"    topk_mask B=8 k=50 ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib:.4f} bound_ms={b:.5f} ({by})", flush=True)
    results["topk_mask"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=b, bound_by=by)
    del pk, pv, v_dense, kg, vg, kgp, vgp, timer
    torch.cuda.empty_cache()

    # -- 4. serve full-width qwen3-1.7b-hashed8 -------------------------------
    print(f"[4] serving {cfg.name}: {cfg.num_layers} layers d={cfg.d_model} "
          f"{cfg.dtype} on seeded weights", flush=True)
    t0 = time.perf_counter()
    model = build(cfg, device="cuda")
    params = model.init(0)
    torch.cuda.synchronize()
    print(f"    init {time.perf_counter() - t0:.1f}s, params "
          f"{sum(p.numel() for p in _leaves(params)) / 1e6:.1f} M real",
          flush=True)
    rng = np.random.default_rng(0)
    shared = rng.integers(2, V, size=96).astype(np.int32)
    plens = [16, 200, 57, 130, 33, 0, 181, 90]
    prompts = []
    for uid, n in enumerate(plens):
        if uid == 5:          # shares request 0..'s 96-token prefix
            prompts.append(np.concatenate(
                [shared, rng.integers(2, V, size=40).astype(np.int32)]))
        elif uid == 1:
            prompts.append(np.concatenate(
                [shared, rng.integers(2, V, size=n - 96).astype(np.int32)]))
        else:
            prompts.append(rng.integers(2, V, size=n).astype(np.int32))
    eng = Engine(model, params, device="cuda", max_concurrency=4,
                 max_len=256, eos_id=-1, page_size=16, prefix_cache=True,
                 prefill_chunk=64, debug_leak_check=True,
                 scheduler=SchedulerConfig(max_queue=16,
                                           max_prefills_per_tick=4))
    reqs = []
    for uid, p in enumerate(prompts):
        sp = SamplingParams(temperature=0.8, top_k=50, seed=uid,
                            max_tokens=16) if uid in (2, 6) \
            else SamplingParams(max_tokens=16)
        reqs.append(Request(uid=uid, prompt=p, sampling=sp))
        if not eng.submit(reqs[-1]):
            fail(f"request {uid} refused")
    K.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_ = K.counts()
    stats = eng.stats()
    eng.shutdown()
    ntok = sum(len(r.tokens) for r in reqs)
    print(f"    {stats['done']}/{len(reqs)} done, {ntok} tokens in "
          f"{wall:.2f}s = {ntok / wall:.1f} tok/s, {stats['ticks']} ticks, "
          f"prefix hit tokens {stats['hit_tokens']}, "
          f"preemptions {stats['preemptions']}", flush=True)
    print(f"    launch counts: {json.dumps(counts_)}", flush=True)
    if stats["done"] != len(reqs) or any(len(r.tokens) != 16 for r in reqs):
        fail("not every request finished with 16 tokens")
    if eng.last_leak_error:
        fail(f"page leak: {eng.last_leak_error}")
    for name, c in counts_.items():
        if c["launches"] <= 0:
            fail(f"kernel {name} was not launched on the main path")
        if c["plain_cuda_calls"] != 0:
            fail(f"plain version of {name} ran on the card on the main path")
    print(f"    stats: {json.dumps(stats)}", flush=True)

    # one decode step on the kernel path against the plain path
    plain_model = build(cfg.with_(hash_path="materialize"), device="cuda")
    rows = [r for r in reqs[:4]]
    feed = [np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
            for r in rows]
    pages = model.init_paged_cache(4 * 16 + 1, 16)
    tbl = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(4, 16)
    smax = max(len(f) for f in feed)
    toks = np.zeros((4, smax), np.int64)
    for i, f in enumerate(feed):
        toks[i, :len(f)] = f
    cnt = torch.tensor([len(f) for f in feed], dtype=torch.int32, device=dev)
    zeros = torch.zeros(4, dtype=torch.int32, device=dev)
    model.prefill_paged(params, torch.from_numpy(toks).to(dev), pages, tbl,
                        zeros, cnt, zeros)
    last = torch.tensor([[r.tokens[-1]] for r in rows], device=dev)
    pages_b = {k: v.clone() for k, v in pages.items()}
    got = model.decode_paged(params, last, pages, tbl, cnt, impl="pallas")
    ref = plain_model.decode_paged(params, last, pages_b, tbl, cnt,
                                   impl="ref")
    torch.cuda.synchronize()
    err, rel = rel_err(got[:, 0, :V], ref[:, 0, :V])
    top2 = torch.topk(ref[:, 0, :V], 2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1])
    decided = margin > 2 * err
    agree = (got[:, 0, :V].argmax(-1) == ref[:, 0, :V].argmax(-1))
    ok = rel <= TOL_LOGITS and bool(agree[decided].all())
    print(f"    decode-step logits kernel vs plain path: max_abs_err="
          f"{err:.3e} rel={rel:.2e} (tol {TOL_LOGITS}); argmax agrees on "
          f"{int(agree[decided].sum())}/{int(decided.sum())} rows whose "
          f"top-2 margin exceeds 2x the error {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        fail("decode-step logits: kernel path disagrees with plain path")

    # -- 5. where a decode step and a prefill dispatch spend their time -------
    steps = {
        "decode step B=4": lambda: model.decode_paged(params, last, pages,
                                                      tbl, cnt),
        "prefill dispatch B=4 S=64": lambda: model.prefill_paged(
            params, torch.from_numpy(toks[:, :64]).to(dev), pages, tbl,
            zeros, torch.full((4,), 64, dtype=torch.int32, device=dev),
            torch.full((4,), 1 << 30, dtype=torch.int32, device=dev)),
    }
    for name, fn in steps.items():
        K.reset_counts()
        fn()
        per_call = {k: v["launches"] for k, v in K.counts().items()}
        wall = Timer(dev)(fn, iters=5, warmup=1)
        print(f"[5] {name}: {wall:.3f} ms on the card (CUDA events, median "
              f"of 5, L2 flushed); kernel launches per call "
              f"{json.dumps(per_call)}", flush=True)
        busy, top = _profile(fn)
        if busy is None:
            print("    profiler: device time not measured (no CUDA events "
                  "in the trace)")
            continue
        print(f"    profiler: device busy {busy:.3f} ms of the call; by "
              f"kernel (self device ms, launches):")
        for kname, ms_, n in top:
            print(f"      {ms_:9.3f} ms {n:5d}x  {kname}")
        torch.cuda.synchronize()

    # -- result line -----------------------------------------------------------
    main_cases = {"hashed_matmul": "hashed_matmul out M=8",
                  "paged_decode": "paged_decode",
                  "paged_prefill": "paged_prefill",
                  "topk_mask": "topk_mask"}
    replaces = {"hashed_matmul": "src/repro/kernels/hashed_matmul.py:81",
                "paged_decode": "src/repro/kernels/paged_attention.py:49",
                "paged_prefill": "src/repro/kernels/flash_prefill.py:54",
                "topk_mask": "src/repro/kernels/topk.py:70"}
    out = []
    for name, (_, _, src) in K.KERNELS.items():
        r = results[main_cases[name]]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces[name],
                    "launches": counts_[name]["launches"],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "shape": main_cases[name]})
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _profile(fn):
    """Device busy time of one call of ``fn`` and its top kernels, from
    ``torch.profiler``; (None, []) when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((e.key[:70], dev_us / 1e3, e.count))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:8]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
