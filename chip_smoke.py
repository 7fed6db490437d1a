"""Quickest proof that the PyTorch/CUDA port starts on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports ``repro_torch`` from ``src/``
and nothing of JAX or the JAX package.  Phases, each failing the script:

1. the card's name and power limit (``nvidia-smi``) and torch's version;
2. build every CUDA kernel from ``src/`` (one ``nvcc`` per source, all
   at once);
3. count the tensor-core instructions in the SASS of every tensor-core
   function (the hashed GEMMs, both ``dw`` products, the bf16 prefill)
   with ``cuobjdump``, where it exists, and the instructions per virtual
   weight in the product loop of the decode-size GEMM (the gemv body;
   printed beside the count its bound takes, which the hash's definition
   fixes);
   hold each kernel against its plain PyTorch version on the card at the
   full-width qwen3-1.7b-hashed8 shapes (the forward GEMM at M = 1 to
   1024 and at M = 8 for attn.k and ffn.up, a one-hot x giving rows of
   the materialized V bitwise at M = 1 and 8; the backward and
   block-mode kernels at M = 1024, the rows of one B=4 x S=256 training
   step; the paged decode at B=8 and at serving's B=4; top-k at B = 1, 8
   and 64, bitwise; each ``dw`` kernel, each tensor-core and gemv GEMM
   and the decode launched twice and bitwise equal to itself; each
   GEMM's and ``dw`` kernel's plan printed, and both ``dw`` kernels
   planned on the tensor cores at every projection), and time kernel,
   plain version and a PyTorch library yardstick with CUDA events
   (median of 20, the L2 flushed before each launch, the host ahead of
   the card), the GEMM bodies forced at M = 1 to 1024 (gemv up to 16),
   both bodies of each ``dw`` kernel and their split counts, top-k's
   cluster sizes;
4. serve qwen3-1.7b-hashed8 at full width (28 layers, bf16, seeded
   weights) through the paged engine: 8 requests, every serving kernel's
   launch count > 0, every element GEMM of at most 16 rows on the gemv
   body and every larger one and every prefill launch on the tensor-core
   body, every top-k with its rows resident in its cluster's shared
   memory, and no plain version run on the card; then one decode step on
   the kernel path against the bf16 plain path (the limit), both also
   measured
   against an fp32 plain path (logit error and argmax agreement);
4b. the same 8 requests with ``batched_prefill=False``, every chunk
   through its row's dense scratch cache (``Model.prefill``): 16 tokens
   each, no page leak, no ragged-prefill launch, every element GEMM of at
   most 16 rows on the gemv body and the rest on the tensor cores, paged
   decode and top-k launched, no plain version on the card; wall and
   device busy time against phase 4's path (the count of requests whose
   tokens equal phase 4's printed, no limit); ``model.prefill`` against
   ``model.prefill_paged`` on the same 4 feeds (last logits within
   ``TOL_LOGITS``, argmax equal where the top-2 margin exceeds twice the
   error); the sampler's Threefry Gumbel field at B=8, V=151936 on the
   card against the CPU (bits bitwise, field within ``TOL_GUMBEL``) and
   its time; ``launch.serve.main --ckpt-dir --stream --stop`` on a params
   checkpoint of ``model.init(1)``, its greedy tokens equal to an
   in-process engine's;
4c. export phase 4's params as ``.hnart`` artifacts, unquantized, int8
   and fp8 (bytes, export seconds, ``report`` totals), register the
   unquantized one and cold-start ``Engine.from_artifact`` from the
   registry to its first token (seconds; the file cache warm): every
   leaf bitwise the saved one, phase 4's requests giving phase 4's
   greedy tokens through every serving kernel and no plain version; the
   int8 and fp8 leaves within ``max_abs_error`` of the originals and one
   decode step's logits printed against phase 4's (finite);
   ``launch.serve --model-name --registry`` and ``--artifact`` giving an
   in-process engine's greedy tokens; ``registry_cli verify`` exiting 0;
4d. self-speculative decoding, k = 3 (a verify block of 16 rows): on
   phase 4's four decode feeds the block against 4 decode steps, each
   sublayer fused alone printed as giving the step's bits or not, and
   the default forms (``Model.block_forms``) bitwise in logits and
   pages; the drafts "1/8" (every leaf aliased) and "1/16" (projected),
   their seconds and bytes; phase 4's requests served with each draft
   and with "1/16" at adaptive k: tokens phase 4's on every request, the
   draft pool's leak audit clean, verify dispatches > 0, every serving
   kernel launched and no plain version; accept rate, dispatches, wall
   and device busy against phase 4's printed (no speed limit);
   ``launch.serve --spec-draft 1/16 --spec-k 3`` giving the spec-off
   engine's greedy tokens;
5. profile a decode step and a prefill dispatch;
6. train qwen3-1.7b-hashed8 at full width (remat on, AdamW, clip 1.0,
   lm_stream batches of B=4 x S=256), element mode and then block mode
   (128 x 128 tiles): one step's loss and bank gradients on the kernel
   path against the plain path, then steps on one repeated batch (the
   loss must fall; every training kernel launched, every ``dw`` launch
   on its tensor-core body, no plain version run on the card), step
   time, peak memory and a profile of one step; then serve 4 requests
   in block mode; then, cut to 2 layers at full width, checkpoint and
   resume through ``launch.train.run`` (4 steps with a checkpoint every
   2, then 6 steps resumed at step 4: the restored state bitwise equal
   to the saved one, the resumed losses within ``TOL_LOSS`` of an
   uninterrupted run; bytes written, save and restore seconds) and train
   with each gradient compressor (the first step's loss equal to the
   uncompressed one, the next finite; wire bytes, step times);
7. the paper's MLPs (784-1000-10 and 784-1000-1000-1000-10, fp32,
   minibatch 50, one global bucket space, compression 1/8 and 1/64):
   (a) one forward and backward of each hashed net, kernel path against
   plain path within ``TOL_FP32``; (b) every layer launched the forward
   and ``dw`` kernels, every layer but the first ``dx``, all on the
   CUDA-core body, no plain version on the card; (c) the three kernels
   timed at the 1000 x 1000 layer, M = 50, 1/64, beside their plain
   version, bound and library call; (d) ``run_method`` for hashed, nn,
   rer and lrd at 1/64 on the ``basic`` analogue (2500 train, 2000 test,
   4 epochs): test errors and median step times, each method's last
   epoch's loss (as the fit records it) below its first.

Prints each phase's seconds, a JSON line of per-kernel numbers (the
serving kernels also with their launches in the 4c and 4d serve runs),
then as its last line ``{"ok": true, "device": {...}}``.
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
TOL_DW = 1e-4                  # fp32 dw from bf16 inputs: sum order only
TOL_FP32 = 1e-4                # fp32 products (gemv, the MLPs): sum order only
TOL_LOSS = 1e-2                # training loss, kernel vs plain path (rel)
TOL_GUMBEL = 1e-6              # Gumbel field, card vs CPU: torch.log only
TOL_GRAD = 0.15                # bank grads: max |d| / max |plain| ...
MIN_COS = 0.99                 # ... and cosine similarity, 28 bf16 layers
                               # forward and back, bf16 scatter in the plain
M_TRAIN = 1024                 # rows of one B=4 x S=256 training step
SWEEP_M = (1, 8, 16, 64, 256, 1024)  # GEMM bodies timed, forced
LANES_PER_CLOCK = 132 * 128    # H100 SXM: SMs x instructions a clock an SM
SERVE_KERNELS = ("hashed_matmul", "paged_decode", "paged_prefill",
                 "topk_mask")
MLP_KERNELS = ("hashed_matmul", "hashed_matmul_t", "hashed_dw")
MLP_M = 50                     # the paper's minibatch
SAMPLED = (2, 6)               # phase 4's seeded sampled requests
SPEC_K = 3                     # phase 4d: a verify block of 4 x 4 rows


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def bound_ms(nbytes: float, flops: float, peak_flops: float,
             issue_ms: float = 0.0):
    """The least time for the work: bytes over the memory rate, or the
    operations over their peak rate (the products' flops, or with
    ``issue_ms`` the instructions the work needs over the SMs' issue
    rate), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / peak_flops * 1e3, issue_ms)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median CUDA-event time of ``fn`` over ``iters`` launches, the L2
    flushed before each (the serving path finds each layer's bank and
    pages cold: a decode step touches ~350 MB of banks).  With
    ``host_ahead`` the card sleeps ~0.5 ms after the flush, so the host
    has enqueued the whole call before the first event fires: the time is
    the device's, without Python's launch cost (phase 3's kernel times;
    phase 5 times whole calls as they run, host cost included)."""

    def __init__(self, dev, host_ahead: bool = False):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        self.host_ahead = host_ahead

    def __call__(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush_buf.zero_()
            if self.host_ahead:
                torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))


class Phases:
    """Wall seconds of each phase (phases 1 and 2 until the first
    ``start``), printed at the end."""

    def __init__(self):
        self.marks = [("1-2 build", time.perf_counter())]

    def start(self, name: str) -> None:
        self.marks.append((name, time.perf_counter()))

    def report(self) -> str:
        ends = [t for _, t in self.marks[1:]] + [time.perf_counter()]
        return ", ".join(f"{name} {end - t0:.1f}s"
                         for (name, t0), end in zip(self.marks, ends))


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
    from repro_torch.kernels import hashed_matmul as THK
    from repro_torch.kernels.hashed_matmul import hashed_matmul_ref
    from repro_torch.kernels import paged_attention as TPA
    from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                     paged_decode_attention)
    from repro_torch.kernels import topk as TTK
    from repro_torch.kernels.topk import topk_mask, topk_mask_ref
    from repro_torch.core import hashed as H
    from repro_torch.models import build
    from repro_torch.models.transformer import bank_spec_map
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.scheduler import SchedulerConfig
    import torch.nn.functional as F

    from repro_torch.core.device import resolve_device

    t_start = time.perf_counter()
    phases = Phases()
    dev = resolve_device("cuda")        # also keeps fp32 products off TF32
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

    check_sass(_build)

    cfg = C.get("qwen3-1.7b-hashed8").with_(hash_path="pallas")
    specs = bank_spec_map(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev, host_ahead=True)
    results = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- 3a. hashed GEMM -------------------------------------------------------
    # M = 1 and 8 are decode and 16 a short prefill (the gemv body), 256 a
    # B=4 x S=64 prefill dispatch, 1024 a training step (the tensor-core
    # body); every gemv and tensor-core product launched twice and bitwise
    # equal to itself, at M <= 8 a one-hot x giving rows of V bitwise and
    # the fp32 gemv within TOL_FP32.  At M in SWEEP_M the bodies are
    # timed, forced (gemv up to 16 rows), for the plan's threshold.  The
    # gemv bound counts the instructions each weight needs by the hash's
    # definition (gemv_ops_per_weight) over the SMs' issue rate at the
    # card's largest SM clock; the SASS count of the kernel's own product
    # loop is printed beside it.
    phases.start("3 kernels")
    print("[3] kernels against their plain versions on the card", flush=True)
    ipw = gemv_instructions(_build)
    mhz = sm_clocks()
    print(f"    SM clock {mhz[0]} MHz now, {mhz[1]} MHz at most (nvidia-smi "
          f"clocks.sm, clocks.max.sm); the gemv bound takes the largest",
          flush=True)
    gemm_slots = {"q": ("layers", "attn", "q", "w"),
                  "k": ("layers", "attn", "k", "w"),
                  "up": ("layers", "ffn", "in", "w"),
                  "out": ("layers", "ffn", "out", "w")}
    for slot, ms_ in (("q", (1, 8, 16, 64, 256, 1024)),
                      ("out", (1, 8, 16, 64, 256, 1024)),
                      ("k", (8,)), ("up", (8,))):
        spec = specs[gemm_slots[slot]]
        kp = spec.buckets_per_panel
        w = randn(spec.num_buckets) * (1.0 / spec.rows ** 0.5)
        v_dense = H.materialize(w, spec, dtype=torch.bfloat16)
        for m in ms_:
            x = randn(m, spec.rows)
            plan = THK.gemm_plan(m, spec.rows, spec.cols, "element", x.dtype)
            got = ops.hashed_matmul(x, w, spec)
            ref = hashed_matmul_ref(x, w, spec)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            ok = rel <= TOL_BF16
            note = repeat_note(plan, lambda: ops.hashed_matmul(x, w, spec),
                               got)
            if m <= 8:
                note += one_hot_note(THK, w, spec, v_dense, m, gen)
                note += fp32_note(THK, x, w, spec)
            ms = timer(lambda: ops.hashed_matmul(x, w, spec))
            plain = timer(lambda: hashed_matmul_ref(x, w, spec))
            lib = timer(lambda: torch.matmul(x, v_dense))
            nbytes = 2 * (m * spec.rows + spec.num_buckets + m * spec.cols)
            issue, need = 0.0, 0
            if plan.body == "gemv":
                need = gemv_ops_per_weight(m, spec.use_sign)
                issue = need * spec.rows * spec.cols \
                    / (LANES_PER_CLOCK * mhz[1] * 1e6) * 1e3
            b, by = bound_ms(nbytes, 2.0 * m * spec.rows * spec.cols,
                             BF16_FLOPS, issue)
            key = f"hashed_matmul {slot} M={m}"
            print(f"    {key}: {spec.rows}x{spec.cols} Kp={kp} "
                  f"max_abs_err={err:.3e} rel={rel:.2e} (tol {TOL_BF16})"
                  f"{note} {'ok' if ok else 'FAIL'}"
                  f"  ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f}"
                  f" bound_ms={b:.5f} ({by}"
                  + (f"; issue {issue:.5f} at {need} instructions a "
                     f"weight, the kernel's loop {ipw.get(plan.bm, 0):.2f}"
                     if issue else "")
                  + f")\n      plan {plan_str(plan)}", flush=True)
            if not ok:
                fail(f"{key} disagrees with its plain version")
            if m in SWEEP_M or slot in ("k", "up"):
                bodies = {}
                names = ("gemv",) if m <= THK.GEMV_MAX_ROWS else ()
                for body in names + ("tensor_core", "cuda_core"):
                    forced = THK.gemm_plan(m, spec.rows, spec.cols,
                                           "element", x.dtype, body=body)
                    bodies[body] = timer(lambda: THK.element_matmul(
                        x, w, spec, plan=forced))
                print(f"      bodies forced: {bodies_str(bodies)}",
                      flush=True)
            results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                library_ms=lib, bound_ms=b, bound_by=by,
                                body=plan.body)
        del v_dense

    # -- 3b. paged decode ------------------------------------------------------
    # B=8 rows of 0 to 256 positions (a length-0 row on the trash page) and
    # serving's B=4; each launched twice and bitwise equal to itself
    nkv, hq, hd, ps = cfg.num_kv_heads, cfg.num_heads, cfg.head_dim, 16
    g = hq // nkv
    maxp, npages = 16, 8 * 16 + 1
    pk = randn(npages, ps, nkv, hd)
    pv = randn(npages, ps, nkv, hd)
    perm = torch.randperm(npages - 1, generator=gen, device=dev) + 1
    table = perm[: 8 * maxp].reshape(8, maxp).to(torch.int32)
    table[0] = 0                                   # idle row: trash page
    kv_pos = torch.arange(maxp * ps, device=dev)

    def check_decode(key, tbl, lens, zero_rows):
        q = randn(tbl.shape[0], hq, hd)
        for window in (0, 48):
            got = paged_decode_attention(q, pk, pv, tbl, lens, window)
            again = paged_decode_attention(q, pk, pv, tbl, lens, window)
            ref = paged_attention_ref(q, pk, pv, tbl, lens, window)
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            zero = all(got[r].abs().max().item() == 0.0 for r in zero_rows)
            same = bool(torch.equal(got, again))
            ok = rel <= TOL_BF16 and zero and same
            print(f"    {key} window={window}: max_abs_err={err:.3e} "
                  f"rel={rel:.2e} (tol {TOL_BF16}) length-0 rows zero="
                  f"{zero} bitwise across two launches={same} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{key} disagrees with its plain version or itself")
        ms = timer(lambda: paged_decode_attention(q, pk, pv, tbl, lens))
        plain = timer(lambda: paged_attention_ref(q, pk, pv, tbl, lens))
        # the yardstick gets K/V gathered by the table and repeated over
        # each kv head's query group, outside the timed call
        kg = pk[tbl.long()].reshape(-1, maxp * ps, nkv, hd).transpose(1, 2) \
            .repeat_interleave(g, dim=1)
        vg = pv[tbl.long()].reshape(-1, maxp * ps, nkv, hd).transpose(1, 2) \
            .repeat_interleave(g, dim=1)
        mask = (kv_pos[None, :] < lens[:, None])[:, None, None, :]
        lib = timer(lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kg, vg, attn_mask=mask))
        live = int(lens.sum())
        nbytes = 2 * (2 * q.numel()) + live * nkv * hd * 2 * 2 \
            + tbl.numel() * 4
        b, by = bound_ms(nbytes, 4.0 * live * hq * hd, BF16_FLOPS)
        print(f"    {key} ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} bound_ms={b:.5f} ({by}); "
              f"{TPA.decode_chunks(maxp, ps)} chunks of "
              f"{TPA.DECODE_CHUNK} positions a row", flush=True)
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b, bound_by=by)

    lengths = torch.tensor([0, 1, 17, 64, 100, 200, 255, 256],
                           dtype=torch.int32, device=dev)
    check_decode("paged_decode", table, lengths, [0])
    # phase 4's first four rows after 15 new tokens
    check_decode("paged_decode B=4", table[4:8].clone(),
                 torch.tensor([31, 215, 72, 145], dtype=torch.int32,
                              device=dev), [])

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
              f"pad/count-0 zero={pad_zero} {'ok' if ok else 'FAIL'}"
              f"\n      body="
              f"{'tensor_core' if qp.dtype == torch.bfloat16 else 'cuda_core'}"
              f" (by dtype)", flush=True)
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
    # B = 8 holds chip_smoke's special rows (ties at the threshold, +-0.0
    # ties, k disabled both ways); B = 1 and 64 random rows with edge k.
    # The default plan and every cluster size, each bitwise equal to the
    # plain version, then timed at k = 50.
    V = cfg.vocab_size
    for B in (1, 8, 64):
        logits = torch.randn(B, V, generator=gen, device=dev)
        if B == 8:
            logits[2, :100] = 3.5                  # ties at the threshold
            logits[3, ::2] = 0.0                   # +-0.0 at the threshold
            logits[3, 1::2] = -0.0
            logits[3, :10] = 1.0
            kvec = torch.tensor([0, 1, 50, 50, V, 20, 50, 7],
                                dtype=torch.int32, device=dev)
        else:
            logits[:, :100] = torch.where(
                torch.arange(B, device=dev)[:, None] % 2 == 0, 3.5,
                logits[:, :100])
            kvec = torch.tensor(([50, 1, V - 1, 0] * B)[:B],
                                dtype=torch.int32, device=dev)
        ref = topk_mask_ref(logits, kvec)
        got = topk_mask(logits, kvec)
        torch.cuda.synchronize()
        same = bool(torch.equal(got, ref))
        err = (got - ref).abs().max().item()
        plan = TTK.topk_plan(B, V, logits.dtype)
        print(f"    topk_mask B={B} V={V} k={kvec.tolist()[:8]}: bitwise "
              f"equal={same} (tol 0: survivors pass through) "
              f"{'ok' if same else 'FAIL'}\n      plan {plan}", flush=True)
        if not same:
            fail(f"topk_mask B={B} disagrees with its plain version")
        k50 = torch.full((B,), 50, dtype=torch.int32, device=dev)
        ms = timer(lambda: topk_mask(logits, k50))
        plain = timer(lambda: topk_mask_ref(logits, k50))
        lib = timer(lambda: torch.topk(logits, 50, dim=-1))
        b, by = bound_ms(2 * logits.numel() * 4, 0.0, FP32_FLOPS)
        print(f"    topk_mask B={B} k=50 ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} bound_ms={b:.5f} ({by})", flush=True)
        sweep = {}
        for cs in TTK.CLUSTER_SIZES:
            forced = TTK.topk_plan(B, V, logits.dtype, cluster=cs)
            if not torch.equal(topk_mask(logits, kvec, plan=forced), ref):
                fail(f"topk_mask B={B} with {forced} disagrees with its "
                     f"plain version")
            sweep[f"{cs}" + ("" if forced.resident else "/s")] = \
                timer(lambda: topk_mask(logits, k50, plan=forced))
        print(f"      CTAs a row forced (/s: streamed), all bitwise: "
              f"{bodies_str(sweep)}", flush=True)
        results[f"topk_mask B={B}"] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain, library_ms=lib,
                                           bound_ms=b, bound_by=by)
    results["topk_mask"] = results["topk_mask B=8"]
    del pk, pv, kgp, vgp
    torch.cuda.empty_cache()

    # -- 3e. the training kernels: dx, dw and block mode at M = 1024 ----------
    specs_b = bank_spec_map(block_config(C, "pallas"))

    def check(key, got, ref, tol, fns, nbytes, flops, extra="", plan=None):
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        ok = rel <= tol
        ms, plain, lib = (timer(f) for f in fns)
        b, by = bound_ms(nbytes, flops, BF16_FLOPS)
        print(f"    {key}: max_abs_err={err:.3e} rel={rel:.2e} (tol {tol})"
              f"{extra} {'ok' if ok else 'FAIL'}  ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms={b:.5f}"
              f" ({by})" + (f"\n      plan {plan_str(plan)}" if plan else ""),
              flush=True)
        if not ok:
            fail(f"{key} disagrees with its plain version")
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b, bound_by=by)
        if plan:
            results[key]["body"] = plan.body

    def bitwise(fn):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        if not same:
            fail("a dw kernel is not bitwise equal to itself across launches")
        return first, f" bitwise across two launches={same}"

    def check_block_dw(slot, x, gy, spec_b):
        """block_dw against its plain version and the matmul + index_add_
        yardstick, bitwise across launches, then its forced plans."""
        m, r, c = x.shape[0], spec_b.rows, spec_b.cols
        plan = THK.block_dw_plan(m, spec_b, x.dtype)
        got, note = bitwise(lambda: THK.block_dw(x, gy, spec_b))
        bidx, bsgn = H.block_indices(spec_b, dev)
        gi, gj = spec_b.tile_grid
        brow, bcol = spec_b.block_shape

        def block_dw_library():
            tiles = torch.matmul(x.t(), gy).float().reshape(
                gi, brow, gj, bcol).permute(0, 2, 1, 3) \
                * bsgn[..., None, None].float()
            return torch.zeros(spec_b.real_param_shape(), device=dev) \
                .index_add_(0, bidx.reshape(-1),
                            tiles.reshape(-1, brow, bcol))
        check(f"block_dw {slot} M={m}", got,
              THK.hashed_dw_ref(x, gy, spec_b), TOL_DW,
              (lambda: THK.block_dw(x, gy, spec_b),
               lambda: THK.hashed_dw_ref(x, gy, spec_b), block_dw_library),
              2 * m * (r + c) + 4 * spec_b.real_param_count(),
              2.0 * m * r * c, note, plan)
        dw_sweep(THK.block_dw, THK.block_dw_plan, x, gy, spec_b, timer,
                 (1, 2, 4, 8, 16))

    def check_element_dw(slot, x, gy, spec):
        """element_dw (paper Eq. 12) against its plain version and the
        matmul + index_add_ yardstick, bitwise across launches, then both
        bodies and 1 / 2 / 4 pieces over M forced."""
        m, r, c = x.shape[0], spec.rows, spec.cols
        plan = THK.element_dw_plan(m, spec, x.dtype)
        got, note = bitwise(lambda: THK.element_dw(x, gy, spec))
        ii = torch.arange(r, device=dev)[:, None]
        jj = torch.arange(c, device=dev)[None, :]
        eidx, esgn = H.element_indices(spec, ii, jj)
        eidx, esgn = eidx.reshape(-1), esgn.reshape(-1).float()
        check(f"hashed_dw {slot} M={m}", got, THK.hashed_dw_ref(x, gy, spec),
              TOL_DW,
              (lambda: THK.element_dw(x, gy, spec),
               lambda: THK.hashed_dw_ref(x, gy, spec),
               lambda: torch.zeros(spec.num_buckets, device=dev).index_add_(
                   0, eidx, torch.matmul(x.t(), gy).float().reshape(-1)
                   * esgn)),
              2 * m * (r + c) + 4 * spec.num_buckets, 2.0 * m * r * c, note,
              plan)
        del eidx, esgn
        dw_sweep(THK.element_dw, THK.element_dw_plan, x, gy, spec, timer,
                 (1, 2, 4))

    # every projection of the main path (bf16, M = 1024) must take the
    # tensor-core x^T g in both modes
    for name, plans, plan_fn in (("element_dw", specs, THK.element_dw_plan),
                                 ("block_dw", specs_b, THK.block_dw_plan)):
        for path, spec_ in plans.items():
            plan = plan_fn(M_TRAIN, spec_, torch.bfloat16)
            if plan.body != "tensor_core":
                fail(f"{name} at {'.'.join(path)} M={M_TRAIN} would run "
                     f"{plan_str(plan)}")
        print(f"    {name} plans at M={M_TRAIN}: tensor_core at all "
              f"{len(plans)} projections", flush=True)

    m = M_TRAIN
    for slot in ("q", "out"):
        path = ("layers", "attn", "q", "w") if slot == "q" \
            else ("layers", "ffn", "out", "w")
        spec, spec_b = specs[path], specs_b[path]
        r, c = spec.rows, spec.cols
        scale = 1.0 / r ** 0.5
        x, gy = randn(m, r), randn(m, c)
        gemm_flops = 2.0 * m * r * c
        # element dx = g @ V^T
        w = randn(spec.num_buckets) * scale
        v_dense = H.materialize(w, spec, dtype=torch.bfloat16)
        plan = THK.gemm_plan(m, c, r, "element", gy.dtype, transpose=True)
        got = THK.element_matmul_t(gy, w, spec)
        check(f"hashed_matmul_t {slot} M={m}", got,
              THK.hashed_matmul_t_ref(gy, w, spec), TOL_BF16,
              (lambda: THK.element_matmul_t(gy, w, spec),
               lambda: THK.hashed_matmul_t_ref(gy, w, spec),
               lambda: torch.matmul(gy, v_dense.t())),
              2 * (m * c + spec.num_buckets + m * r), gemm_flops,
              repeat_note(plan, lambda: THK.element_matmul_t(gy, w, spec),
                          got), plan)
        check_element_dw(slot, x, gy, spec)
        del v_dense
        # block mode, 128 x 128 tiles
        wb = randn(*spec_b.real_param_shape()) * scale
        vb = H.materialize(wb, spec_b, dtype=torch.bfloat16)
        bank_bytes = 2 * wb.numel()
        bcols = spec_b.block_shape[1]
        plan = THK.gemm_plan(m, r, c, "block", x.dtype, block_cols=bcols)
        got = THK.block_matmul(x, wb, spec_b)
        check(f"block_matmul {slot} M={m}", got,
              hashed_matmul_ref(x, wb, spec_b), TOL_BF16,
              (lambda: THK.block_matmul(x, wb, spec_b),
               lambda: hashed_matmul_ref(x, wb, spec_b),
               lambda: torch.matmul(x, vb)),
              2 * m * (r + c) + bank_bytes, gemm_flops,
              repeat_note(plan, lambda: THK.block_matmul(x, wb, spec_b), got),
              plan)
        plan = THK.gemm_plan(m, c, r, "block", gy.dtype, block_cols=bcols,
                             transpose=True)
        got = THK.block_matmul(gy, wb, spec_b, transpose=True)
        check(f"block_matmul_t {slot} M={m}", got,
              THK.hashed_matmul_t_ref(gy, wb, spec_b), TOL_BF16,
              (lambda: THK.block_matmul(gy, wb, spec_b, transpose=True),
               lambda: THK.hashed_matmul_t_ref(gy, wb, spec_b),
               lambda: torch.matmul(gy, vb.t())),
              2 * m * (r + c) + bank_bytes, gemm_flops,
              repeat_note(plan, lambda: THK.block_matmul(
                  gy, wb, spec_b, transpose=True), got), plan)
        check_block_dw(slot, x, gy, spec_b)
        del vb
    # attn.k: 16 bank tiles, the fewest (the splits must fill the SMs);
    # 128 output tiles of the element product on 132 SMs
    path = ("layers", "attn", "k", "w")
    x, gy = randn(m, specs[path].rows), randn(m, specs[path].cols)
    check_element_dw("k", x, gy, specs[path])
    check_block_dw("k", x, gy, specs_b[path])
    del timer
    torch.cuda.empty_cache()

    # -- 4. serve full-width qwen3-1.7b-hashed8 -------------------------------
    phases.start("4 serve")
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
    eng, reqs = serve_engine(model, params, prompts, batched=True)
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
    check_counts(counts_, SERVE_KERNELS, "serving")
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
    # both paths against an fp32 oracle: the plain path in fp32 on the
    # same weights, its own fp32 cache prefilled on the plain path
    # (measured; the limit above stays the one check)
    model32 = build(cfg.with_(hash_path="materialize", dtype="float32"),
                    device="cuda")
    params32 = _to_fp32(params)
    pages32 = model32.init_paged_cache(4 * 16 + 1, 16)
    model32.prefill_paged(params32, torch.from_numpy(toks).to(dev), pages32,
                          tbl, zeros, cnt, zeros, impl="ref")
    oracle = model32.decode_paged(params32, last, pages32, tbl, cnt,
                                  impl="ref")[:, 0, :V]
    torch.cuda.synchronize()
    for name, z in (("kernel path", got[:, 0, :V]),
                    ("bf16 plain path", ref[:, 0, :V])):
        e, r = rel_err(z, oracle)
        right = int((z.argmax(-1) == oracle.argmax(-1)).sum())
        print(f"    decode-step logits {name} vs fp32 plain path: "
              f"max_abs_err={e:.3e} rel={r:.2e}; argmax equal on "
              f"{right}/{z.shape[0]} rows (measured, no limit)", flush=True)
    del model32, params32, pages32, oracle
    torch.cuda.empty_cache()
    if not ok:
        fail("decode-step logits: kernel path disagrees with plain path")

    # -- 4b. the same requests through the sequential scratch-cache prefill --
    phases.start("4b sequential serve")
    path_counts = {"serve": counts_}
    path_counts["serve sequential"] = seq_serve_phase(
        model, params, prompts, reqs, wall, feed, cfg, results)
    torch.cuda.empty_cache()

    # -- 4c. compressed artifacts: export, registry, cold start ---------------
    phases.start("4c artifact")
    step4 = {"toks": torch.from_numpy(toks).to(dev), "tbl": tbl, "cnt": cnt,
             "last": last, "logits": got[:, 0, :V]}
    path_counts["serve artifact"] = artifact_phase(
        model, params, prompts, reqs, step4, card)
    torch.cuda.empty_cache()

    # -- 4d. self-speculative decoding ----------------------------------------
    phases.start("4d spec")
    path_counts["serve spec"] = spec_phase(model, params, prompts, reqs,
                                           wall, step4, card)
    del step4
    torch.cuda.empty_cache()

    # -- 5. where a decode step and a prefill dispatch spend their time -------
    phases.start("5 profile")
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

    # -- 6. training at full width, element mode then block mode -------------
    phases.start("6 train")
    from repro_torch.data import lm_stream
    tb = next(lm_stream.batches(seed=17, batch=4, seq_len=256,
                                vocab=cfg.vocab_size))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in tb.items()}
    del model, plain_model, params, pages, pages_b, eng
    torch.cuda.empty_cache()
    cfg_e = C.get("qwen3-1.7b-hashed8")
    path_counts["train element"], _ = train_phase(
        "element", cfg_e, cfg_e.with_(hash_path="materialize"), batch, 8,
        ("hashed_matmul", "hashed_matmul_t", "hashed_dw"))
    torch.cuda.empty_cache()
    cfg_b = block_config(C, "pallas")
    path_counts["train block"], state = train_phase(
        "block", cfg_b, block_config(C, "materialize"), batch, 4,
        ("block_matmul", "block_dw"))

    # block mode on the serving path (the block forward kernel at M <= 8)
    model_b = build(cfg_b, device="cuda")
    eng = Engine(model_b, state["params"], device="cuda", max_concurrency=4,
                 max_len=128, eos_id=-1, page_size=16, prefill_chunk=64,
                 debug_leak_check=True)
    reqs = [Request(uid=u, prompt=rng.integers(2, V, size=n).astype(np.int32),
                    sampling=SamplingParams(max_tokens=8))
            for u, n in enumerate((40, 7, 90, 23))]
    for r in reqs:
        if not eng.submit(r):
            fail(f"block-mode request {r.uid} refused")
    K.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path_counts["serve block"] = K.counts()
    stats = eng.stats()
    eng.shutdown()
    print(f"[6] block-mode serving: {stats['done']}/{len(reqs)} done, "
          f"{sum(len(r.tokens) for r in reqs)} tokens in {wall:.2f}s; "
          f"launch counts {json.dumps(path_counts['serve block'])}",
          flush=True)
    if stats["done"] != len(reqs) or any(len(r.tokens) != 8 for r in reqs):
        fail("block-mode serving: not every request finished with 8 tokens")
    if eng.last_leak_error:
        fail(f"block-mode serving: page leak: {eng.last_leak_error}")
    check_counts(path_counts["serve block"],
                 ("block_matmul", "paged_decode", "paged_prefill"),
                 "block-mode serving")
    del model_b, eng, state
    torch.cuda.empty_cache()

    # checkpoint, resume and gradient compression through launch.train
    phases.start("6 ckpt+compress")
    ckpt_phase(C)
    torch.cuda.empty_cache()

    # -- 7. the paper's MLPs through the hashed kernels ------------------------
    phases.start("7 mlp")
    path_counts["mlp"] = mlp_phase(dev, results)
    torch.cuda.empty_cache()

    # -- result line -----------------------------------------------------------
    # kernel -> (the case timed in phase 3, the path whose launches count,
    #            the TPU kernel it replaces)
    tpu = "src/repro/kernels/"
    rows = {
        "hashed_matmul": ("hashed_matmul out M=8", "serve",
                          tpu + "hashed_matmul.py:81"),
        "hashed_matmul_t": (f"hashed_matmul_t out M={M_TRAIN}",
                            "train element", tpu + "hashed_matmul.py:138"),
        "hashed_dw": (f"hashed_dw out M={M_TRAIN}", "train element",
                      tpu + "hashed_matmul.py:160"),
        "block_matmul": (f"block_matmul out M={M_TRAIN}", "train block",
                         tpu + "hashed_matmul.py:237"),
        "block_dw": (f"block_dw out M={M_TRAIN}", "train block",
                     tpu + "hashed_matmul.py:323"),
        "paged_decode": ("paged_decode", "serve",
                         tpu + "paged_attention.py:49"),
        "paged_prefill": ("paged_prefill", "serve",
                          tpu + "flash_prefill.py:54"),
        "topk_mask": ("topk_mask", "serve", tpu + "topk.py:70"),
    }
    # more timed shapes of a kernel, beside its row's case
    more = {"hashed_matmul": ["hashed_matmul out M=1",
                              "hashed_matmul q M=8", "hashed_matmul k M=8",
                              "hashed_matmul up M=8",
                              "hashed_matmul out M=256",
                              f"hashed_matmul out M={M_TRAIN}",
                              f"hashed_matmul q M={M_TRAIN}"],
            "hashed_matmul_t": [f"hashed_matmul_t q M={M_TRAIN}"],
            "hashed_dw": [f"hashed_dw q M={M_TRAIN}",
                          f"hashed_dw k M={M_TRAIN}"],
            "paged_decode": ["paged_decode B=4"],
            "topk_mask": ["topk_mask B=1", "topk_mask B=64"],
            "block_matmul": [f"block_matmul_t out M={M_TRAIN}",
                             f"block_matmul q M={M_TRAIN}",
                             f"block_matmul_t q M={M_TRAIN}"],
            "block_dw": [f"block_dw q M={M_TRAIN}", f"block_dw k M={M_TRAIN}"]}
    for name in MLP_KERNELS:
        more[name].append(f"{name} mlp 1000x1000 M={MLP_M} fp32")
    out = []
    for name, (_, _, src) in K.KERNELS.items():
        case, path, replaces = rows[name]
        r = results[case]
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": path_counts[path][name]["launches"],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"],
               "shape": case, "path": path}
        if name in more:
            row["cases"] = [dict(shape=c, **results[c]) for c in more[name]]
        if name in SERVE_KERNELS:
            # the artifact cold-start and speculative serve runs (4c, 4d)
            row["artifact_serve_launches"] = \
                path_counts["serve artifact"][name]["launches"]
            row["spec_serve_launches"] = \
                path_counts["serve spec"][name]["launches"]
        if name in MLP_KERNELS:
            # one forward and backward of 784-1000-10 at 1/64 (phase 7)
            row["mlp_step_launches"] = path_counts["mlp"][name]["launches"]
        out.append(row)
    print(f"phase seconds: {phases.report()}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f}s", flush=True)
    print(card)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def engine_knobs():
    """Phase 4's engine knobs: max concurrency 4, page size 16, prefix
    cache, chunk 64, at most 4 chunk steps a tick, the leak audit on."""
    from repro_torch.serving.scheduler import SchedulerConfig
    return dict(max_concurrency=4, max_len=256, eos_id=-1, page_size=16,
                prefix_cache=True, prefill_chunk=64, debug_leak_check=True,
                scheduler=SchedulerConfig(max_queue=16,
                                          max_prefills_per_tick=4))


def submit_requests(eng, prompts):
    """Phase 4's 8 requests, rows 2 and 6 sampled (seeded), the others
    greedy, 16 tokens each."""
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Request
    reqs = []
    for uid, p in enumerate(prompts):
        sp = SamplingParams(temperature=0.8, top_k=50, seed=uid,
                            max_tokens=16) if uid in SAMPLED \
            else SamplingParams(max_tokens=16)
        reqs.append(Request(uid=uid, prompt=p, sampling=sp))
        if not eng.submit(reqs[-1]):
            fail(f"request {uid} refused")
    return reqs


def serve_engine(model, params, prompts, batched: bool, **extra):
    """Phase 4's engine holding its 8 requests; ``batched`` picks the
    ragged batched prefill or the sequential scratch-cache one; ``extra``
    (a draft, ``spec_k``) passes to the Engine."""
    from repro_torch.serving.engine import Engine
    eng = Engine(model, params, device=model.device,
                 batched_prefill=batched, **engine_knobs(), **extra)
    return eng, submit_requests(eng, prompts)


def seq_serve_phase(model, params, prompts, reqs4, wall4, feeds, cfg,
                    results) -> dict:
    """Phase 4b: phase 4's requests with ``batched_prefill=False`` (every
    chunk through the dense scratch cache, ``Model.prefill``): 16 tokens
    each, no page leak, no ragged-prefill launch, every element GEMM of
    at most 16 rows on the gemv body and the rest on the tensor cores,
    paged decode and top-k launched, no plain version on the card; wall
    and device busy time of both paths; ``model.prefill`` against
    ``model.prefill_paged`` on phase 4's four decode feeds; the sampler's
    Gumbel field on the card against the CPU at B=8, V=151936; and
    ``launch.serve.main`` serving a params checkpoint with ``--ckpt-dir
    --stream --stop``, its greedy tokens equal to an in-process engine's.
    Returns the sequential run's launch counts."""
    from repro_torch import kernels as K
    dev = model.device
    V = cfg.vocab_size
    eng, reqs = serve_engine(model, params, prompts, batched=False)
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
    same = sum(r.tokens == q.tokens for r, q in zip(reqs, reqs4))
    print(f"[4b] sequential prefill: {stats['done']}/{len(reqs)} done, "
          f"{ntok} tokens in {wall:.2f}s = {ntok / wall:.1f} tok/s "
          f"(phase 4 batched {wall4:.2f}s), {stats['ticks']} ticks, "
          f"prefix hit tokens {stats['hit_tokens']}, sampler "
          f"{stats['sampler_time_s']:.3f}s; tokens equal to "
          f"phase 4's in {same}/{len(reqs)} requests (measured, no limit)",
          flush=True)
    print(f"    launch counts: {json.dumps(counts_)}", flush=True)
    if stats["done"] != len(reqs) or any(len(r.tokens) != 16 for r in reqs):
        fail("sequential serving: not every request finished with 16 "
             "tokens")
    if eng.last_leak_error:
        fail(f"sequential serving: page leak: {eng.last_leak_error}")
    if counts_["paged_prefill"]["launches"] != 0:
        fail("sequential serving launched the ragged prefill kernel")
    check_counts(counts_, ("hashed_matmul", "paged_decode", "topk_mask"),
                 "sequential serving")
    del eng
    for batched in (True, False):
        eng, _ = serve_engine(model, params, prompts, batched=batched)
        busy, top = _profile(eng.run, cpu=False)
        eng.shutdown()
        name = "batched" if batched else "sequential"
        if busy is None:
            print(f"    {name} serve run: device busy not measured (no "
                  f"CUDA events in the trace)", flush=True)
            continue
        print(f"    {name} serve run: device busy {busy:.3f} ms "
              f"(profiler, one run); top kernels: "
              + "; ".join(f"{k} {ms:.3f} ms {n}x" for k, ms, n in top[:4]),
              flush=True)
        del eng
    torch.cuda.empty_cache()

    # the dense scratch against the paged prefill on the same 4 feeds
    n = len(feeds)
    pages = model.init_paged_cache(n * 16 + 1, 16)
    tbl = torch.arange(1, n * 16 + 1, dtype=torch.int32,
                       device=dev).reshape(n, 16)
    smax = max(len(f) for f in feeds)
    toks = np.zeros((n, smax), np.int64)
    for i, f in enumerate(feeds):
        toks[i, :len(f)] = f
    cnt = torch.tensor([len(f) for f in feeds], dtype=torch.int32,
                       device=dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    x_last = model.prefill_paged(params, torch.from_numpy(toks).to(dev),
                                 pages, tbl, zeros, cnt, zeros)
    paged = torch.cat([model.logits_head(params, x_last[i:i + 1])[:, -1, :V]
                       for i in range(n)])
    dense = []
    for f in feeds:
        bucket = -(-len(f) // 64) * 64
        t = np.zeros((1, bucket), np.int64)
        t[0, :len(f)] = f
        lg, _ = model.prefill(params, {
            "tokens": torch.from_numpy(t).to(dev),
            "cache": model.init_cache(1, 256), "length": len(f)})
        dense.append(lg[:, -1, :V])
    dense = torch.cat(dense)
    torch.cuda.synchronize()
    err, rel = rel_err(dense, paged)
    top2 = torch.topk(paged, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * err
    agree = dense.argmax(-1) == paged.argmax(-1)
    ok = rel <= TOL_LOGITS and bool(agree[decided].all())
    print(f"    last logits, dense scratch prefill vs paged prefill on "
          f"{n} feeds of {', '.join(str(len(f)) for f in feeds)} tokens: "
          f"max_abs_err={err:.3e} rel={rel:.2e} (tol {TOL_LOGITS}); argmax "
          f"agrees on {int(agree[decided].sum())}/{int(decided.sum())} "
          f"rows whose top-2 margin exceeds 2x the error "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail("dense scratch prefill disagrees with the paged prefill")
    del pages, x_last, paged, dense

    gumbel_check(dev, V, results)
    serve_ckpt_check(model, ["--arch", "qwen3-1.7b", "--hashed"])
    return counts_


def _flat(tree):
    from repro_torch.artifact.format import flatten_with_paths
    return flatten_with_paths(tree)


def _run_launcher(argv):
    """``launch.serve.main(argv)`` in process: (exit code, {uid: tokens},
    its standard output)."""
    import contextlib
    import io
    import re
    from repro_torch.launch import serve
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    got = {}
    for line in out.getvalue().splitlines():
        m = re.match(r"^req (\d+): (\[[^\]]*\])  \(finish=(\w+)", line)
        if m:
            got[int(m.group(1))] = json.loads(m.group(2))
    return rc, got, out.getvalue()


def _launcher_want(model, params, n=4, max_new=8):
    """The greedy tokens ``launch.serve`` gives its first ``n`` prompts
    with its default knobs, from an in-process engine on ``params``."""
    from repro_torch.launch import serve
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine, Request
    eng = Engine(model, params, device=model.device, max_concurrency=4,
                 max_len=256, eos_id=-1)
    for uid, p in enumerate(serve.prompts(n, model.cfg.vocab_size)):
        eng.submit(Request(uid=uid, prompt=p,
                           sampling=SamplingParams(max_tokens=max_new)))
    eng.run()
    return {r.uid: r.tokens for r in eng._done}


def artifact_phase(model, params, prompts, reqs4, step, card) -> dict:
    """Phase 4c: export the params as ``.hnart`` artifacts three ways
    (unquantized, int8, fp8: bytes, export seconds, ``report`` totals),
    register the unquantized one and cold-start an engine from the
    registry (resolve with its sha256, map, one host-to-device copy) to
    its first token, then serve phase 4's requests: every loaded leaf
    bitwise the saved one, the greedy tokens phase 4's, every serving
    kernel launched and no plain version on the card.  The int8 and fp8
    files: every quantized leaf within ``max_abs_error`` of the original
    (plus half a bf16 ulp for the restore cast), every other leaf
    bitwise, and one decode step's logits printed against phase 4's
    (finite, no other limit).  ``launch.serve --model-name --registry``
    and ``--artifact`` give an in-process engine's greedy tokens, and
    ``registry_cli verify`` exits 0.  Returns the cold engine's launch
    counts."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    from repro_torch import artifact
    from repro_torch import kernels as K
    from repro_torch.artifact import io as aio
    from repro_torch.artifact import quant as Q
    from repro_torch.artifact import registry as reg
    from repro_torch.artifact import report
    from repro_torch.launch import registry_cli
    from repro_torch.serving.engine import Engine
    cfg = model.cfg
    V = cfg.vocab_size
    d = tempfile.mkdtemp(prefix="chip_smoke_art_")
    try:
        files = {}
        for quant in ("none", "int8", "fp8"):
            path = os.path.join(d, f"m_{quant}.hnart")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            header = artifact.export_model(path, cfg, params, quant=quant)
            dt = time.perf_counter() - t0
            tot = report.totals(report.artifact_rows(header), header)
            files[quant] = path
            print(f"[4c] export {quant}: {os.path.getsize(path)} B in "
                  f"{dt:.2f} s; report totals: virtual "
                  f"{tot['virtual_bytes']} B, real {tot['real_bytes']} B, "
                  f"disk {tot['disk_bytes']} B + header "
                  f"{tot['header_bytes']} B, disk/dense "
                  f"{tot['disk_ratio']:.4f}, real/virtual params "
                  f"{tot['param_ratio']:.4f} ({card})", flush=True)
        root = os.path.join(d, "reg")
        t0 = time.perf_counter()
        version = reg.register(root, cfg.name, files["none"])
        t_reg = time.perf_counter() - t0

        # cold start: resolve (sha256 read) + map + one H2D copy + engine,
        # then the first token of phase 4's requests
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = Engine.from_artifact(cfg.name, registry_root=root,
                                   device=model.device, **engine_knobs())
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        K.reset_counts()
        reqs = submit_requests(eng, prompts)
        while not any(r.tokens for r in reqs):
            eng.step()
        t_first = time.perf_counter() - t0
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_ = K.counts()
        stats = eng.stats()
        eng.shutdown()
        same_leaves = all(torch.equal(a, b) for (_, a), (_, b) in
                          zip(_flat(params), _flat(eng.params)))
        greedy = [u for u in range(len(reqs)) if u not in SAMPLED]
        same_greedy = all(reqs[u].tokens == reqs4[u].tokens for u in greedy)
        same_all = sum(r.tokens == q.tokens for r, q in zip(reqs, reqs4))
        print(f"[4c] cold start {cfg.name}@{version} (registered in "
              f"{t_reg:.2f} s): {t_load:.2f} s to params on the card, "
              f"{t_first:.2f} s to the first token, {wall:.2f} s to serve "
              f"all 8 (file cache warm: the file was written in this run; "
              f"{card}); leaves bitwise the saved ones: {same_leaves}; "
              f"greedy tokens phase 4's: {same_greedy}; all tokens equal "
              f"in {same_all}/{len(reqs)}", flush=True)
        print(f"    launch counts: {json.dumps(counts_)}", flush=True)
        if not same_leaves:
            fail("artifact: a loaded leaf differs from the saved one")
        if not same_greedy:
            fail("artifact: greedy tokens differ from phase 4's")
        if stats["done"] != len(reqs) or eng.last_leak_error:
            fail(f"artifact serving: {stats['done']} done, leak "
                 f"{eng.last_leak_error}")
        check_counts(counts_, SERVE_KERNELS, "artifact serving")
        del eng

        # int8 / fp8: leaves within the bound, one decode step's logits
        zeros = torch.zeros(4, dtype=torch.int32, device=model.device)
        for quant in ("int8", "fp8"):
            hdr, mm = aio.open_artifact(files[quant])
            _, qp = artifact.load(files[quant], device=model.device)
            worst, n_q = 0.0, 0
            for e, (p, a), (_, b) in zip(hdr["leaves"], _flat(params),
                                         _flat(qp)):
                if e["quant"] is None:
                    if not torch.equal(a, b):
                        fail(f"{quant} artifact: exact leaf {p} differs")
                    continue
                z = aio.read_leaf(hdr, mm, e, dequant=False)
                bound = Q.max_abs_error(z.scheme, z.scales)
                if a.dtype == torch.bfloat16:
                    bound += 2.0 ** -8 * float(a.float().abs().max())
                err = float((b.float() - a.float()).abs().max())
                worst = max(worst, err / bound if bound else 0.0)
                n_q += 1
                if err > bound:
                    fail(f"{quant} artifact: leaf {p} off by {err:.3e} > "
                         f"its bound {bound:.3e}")
            pages = model.init_paged_cache(4 * 16 + 1, 16)
            model.prefill_paged(qp, step["toks"], pages, step["tbl"], zeros,
                                step["cnt"], zeros)
            lg = model.decode_paged(qp, step["last"], pages, step["tbl"],
                                    step["cnt"])[:, 0, :V]
            torch.cuda.synchronize()
            err, rel = rel_err(lg, step["logits"])
            agree = int((lg.argmax(-1) == step["logits"].argmax(-1)).sum())
            print(f"[4c] {quant}: {n_q} quantized leaves within their "
                  f"bound (worst err/bound {worst:.3f}); one decode step's "
                  f"logits against phase 4's: max_abs_err={err:.3e} "
                  f"rel={rel:.2e}, argmax equal on {agree}/4 rows "
                  f"(measured, no limit; {card})", flush=True)
            if not bool(torch.isfinite(lg).all()):
                fail(f"{quant} artifact: non-finite logits")
            del qp, pages, mm
        torch.cuda.empty_cache()

        # the launcher from the registry and from the file, and the CLI
        want = _launcher_want(model, params)
        for src in (["--model-name", f"{cfg.name}@{version}", "--registry",
                     root], ["--artifact", files["none"]]):
            rc, got, text = _run_launcher(src + ["--requests", "4",
                                                 "--max-new", "8"])
            secs = [ln for ln in text.splitlines()
                    if ln.startswith("cold start from artifact")]
            ok = rc == 0 and got == want and bool(secs)
            print(f"[4c] launch.serve {src[0]}: {secs[0] if secs else '?'} "
                  f"({card}); greedy tokens equal to the in-process "
                  f"engine's: {got == want} {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                print(text[-3000:], flush=True)
                fail(f"launch.serve {src[0]} did not serve the artifact's "
                     f"tokens")
            torch.cuda.empty_cache()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = registry_cli.main(["--registry", root, "verify"])
        print(f"[4c] registry_cli verify: exit {rc}; "
              f"{out.getvalue().strip().splitlines()[-1]}", flush=True)
        if rc != 0:
            fail("registry_cli verify failed")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return counts_


def spec_phase(model, params, prompts, reqs4, wall4, step, card) -> dict:
    """Phase 4d: self-speculative decoding on phase 4's requests
    (concurrency 4, k = SPEC_K: a verify block of 16 rows).  First, on
    phase 4's four decode feeds, the verify block against k+1 successive
    decode steps: each sublayer fused alone (the others per slot) printed
    as giving the step's bits or not, and the default forms
    (``Model.block_forms``) bitwise, logits and pages (the limit).  Then
    the drafts "1/8" (every leaf aliased) and "1/16" (projected): their
    derivation seconds and bytes; each served with fixed k and "1/16"
    also with adaptive k: tokens phase 4's on every request, the draft
    pool's leak audit clean, verify dispatches > 0, every serving kernel
    launched and no plain version on the card; accept rate, dispatches,
    wall, and the device busy of one steady tick against phase 4's path
    printed, no speed limit.
    Last, ``launch.serve --spec-draft 1/16 --spec-k 3`` against an
    in-process engine's greedy tokens.  Returns the "1/16" run's launch
    counts."""
    from repro_torch import kernels as K
    from repro_torch.models.transformer import BLOCK_SUBLAYERS
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving import draft as D
    cfg = model.cfg
    V = cfg.vocab_size
    dev = model.device
    B, S = 4, SPEC_K + 1

    # -- the verify block against k+1 decode steps ---------------------------
    rng = np.random.default_rng(7)
    blk = torch.cat([step["last"], torch.from_numpy(rng.integers(
        2, V, (B, SPEC_K))).to(dev)], dim=1)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    pages0 = model.init_paged_cache(B * 16 + 1, 16)
    model.prefill_paged(params, step["toks"], pages0, step["tbl"], zeros,
                        step["cnt"], zeros)
    pages_s = {k: v.clone() for k, v in pages0.items()}
    want = torch.stack([model.decode_paged(
        params, blk[:, s:s + 1], pages_s, step["tbl"], step["cnt"] + s)[:, 0]
        for s in range(S)], dim=1)
    counts = torch.full((B,), S, dtype=torch.int32, device=dev)

    def block(forms):
        pages_b = {k: v.clone() for k, v in pages0.items()}
        out = model.decode_paged_block(params, blk, pages_b, step["tbl"],
                                       step["cnt"], counts, forms=forms)
        torch.cuda.synchronize()
        same_pages = all(torch.equal(pages_b[k], pages_s[k])
                         for k in ("k", "v"))
        return out, same_pages

    measured = {}
    for name in BLOCK_SUBLAYERS:
        forms = {n: "slot" for n in BLOCK_SUBLAYERS}
        forms[name] = "fused"
        got, same_pages = block(forms)
        measured[name] = bool(torch.equal(got, want)) and same_pages
    got, _ = block({n: "fused" for n in BLOCK_SUBLAYERS})
    err_fused = float((got.float() - want.float()).abs().max())
    forms = model.block_forms(B, S)
    got, same_pages = block(None)
    bitwise = bool(torch.equal(got, want)) and same_pages
    print(f"[4d] verify block B={B} x S={S} against {S} decode steps on "
          f"phase 4's feeds: fused alone gives the step's bits: "
          + ", ".join(f"{n} {'yes' if ok else 'no'}"
                      for n, ok in measured.items())
          + f"; all fused: max_abs_err {err_fused:.3e}; default forms "
          + json.dumps(forms) + f": logits and pages bitwise {bitwise} "
          f"({card})", flush=True)
    if not bitwise:
        fail("verify block: logits differ from the decode steps'")
    del pages0, pages_s, want, got

    # -- drafts ----------------------------------------------------------------
    base_ptrs = {p: t.data_ptr() for p, t in _flat(params)}
    drafts = {}
    for ratio in ("1/8", "1/16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, dm, dp = D.build_draft(cfg, params, ratio)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        leaves = _flat(dp)
        total = sum(t.numel() * t.element_size() for _, t in leaves)
        own = sum(t.numel() * t.element_size() for p, t in leaves
                  if t.data_ptr() != base_ptrs[p])
        aliased = sum(t.data_ptr() == base_ptrs[p] for p, t in leaves)
        print(f"[4d] draft {ratio}: derived in {dt:.2f} s, {total} B of "
              f"params of which {own} B its own ({aliased}/{len(leaves)} "
              f"leaves aliased to the served ones; {card})", flush=True)
        if ratio == "1/8" and own:
            fail("draft 1/8: a leaf was copied, not aliased")
        drafts[ratio] = (dm, dp)

    # -- serving ---------------------------------------------------------------
    runs = [("off", None, False), ("1/8", "1/8", False),
            ("1/16", "1/16", False), ("1/16 adaptive", "1/16", True)]
    counts16 = None
    for label, ratio, adaptive in runs:
        extra = {} if ratio is None else dict(
            draft=drafts[ratio], spec_k=SPEC_K, spec_adaptive=adaptive)
        tracer = Tracer(enabled=True)
        eng, reqs = serve_engine(model, params, prompts, batched=True,
                                 tracer=tracer, **extra)
        K.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts_ = K.counts()
        stats = eng.stats()
        if eng.spec is not None:
            eng.spec.leak_check()
        eng.shutdown()
        same = sum(r.tokens == q.tokens for r, q in zip(reqs, reqs4))
        sp = stats.get("spec", {})
        print(f"[4d] serve {label}: {stats['done']}/{len(reqs)} done in "
              f"{wall:.2f} s (phase 4 {wall4:.2f} s), {stats['ticks']} "
              f"ticks; tokens equal to phase 4's in {same}/{len(reqs)}"
              + (f"; accept rate {sp['accept_rate']:.3f}, mean accept "
                 f"length {sp['mean_accept_len']:.2f}, k {sp['k']}, "
                 f"{sp['draft_dispatches']} draft / "
                 f"{sp['verify_dispatches']} verify dispatches, "
                 f"{sp['baseline_rows']} baseline rows" if sp else "")
              + f" ({card})", flush=True)
        span = {}
        for ev in tracer.events:
            if ev["ph"] == "X":
                span[ev["name"]] = span.get(ev["name"], 0.0) + ev["dur"] / 1e6
        if sp:
            print(f"    host spans (tracer): ticks {span['tick']:.2f} s, "
                  f"propose {span.get('spec:propose', 0.0):.2f} s, verify "
                  f"{span['spec:verify']:.2f} s = "
                  f"{100 * span['spec:verify'] / span['tick']:.1f} % of "
                  f"the ticks' wall ({card})", flush=True)
        print(f"    launch counts: {json.dumps(counts_)}", flush=True)
        if same != len(reqs) or stats["done"] != len(reqs):
            fail(f"spec serving {label}: tokens differ from phase 4's")
        if eng.last_leak_error:
            fail(f"spec serving {label}: leak: {eng.last_leak_error}")
        if ratio is not None and sp["verify_dispatches"] <= 0:
            fail(f"spec serving {label}: no verify dispatch")
        check_counts(counts_, SERVE_KERNELS, f"spec serving {label}")
        if label == "1/16":
            counts16 = counts_
        if label != "1/16 adaptive":
            # device busy of one steady tick (every row decoding): a whole
            # run's trace holds ~10^5 launches, minutes of the profiler's
            # parsing
            del eng
            eng, _ = serve_engine(model, params, prompts, batched=True,
                                  **extra)
            for _ in range(64):
                if not eng._prefilling and all(r is not None
                                               for r in eng.rows):
                    break
                eng.step()
            n0 = int(eng._counts["tokens"])
            busy, top = _profile(eng.step, cpu=False)
            n = int(eng._counts["tokens"]) - n0
            print(f"    one steady tick: {n} tokens committed, device busy "
                  + (f"{busy:.3f} ms = {busy / max(n, 1):.3f} ms a token "
                     f"(profiler); top kernels: " + "; ".join(
                         f"{k} {ms:.3f} ms {c}x" for k, ms, c in top[:4])
                     if busy is not None else "not measured (no CUDA "
                     "events in the trace)") + f" ({card})", flush=True)
        del eng
        torch.cuda.empty_cache()
    del drafts

    # -- the launcher ----------------------------------------------------------
    want = _launcher_want(model, params)
    rc, got, text = _run_launcher(["--arch", "qwen3-1.7b", "--hashed",
                                   "--requests", "4", "--max-new", "8",
                                   "--spec-draft", "1/16", "--spec-k",
                                   str(SPEC_K)])
    line = [ln for ln in text.splitlines() if ln.startswith("spec decode:")]
    ok = rc == 0 and got == want and bool(line)
    print(f"[4d] launch.serve --spec-draft 1/16 --spec-k {SPEC_K}: "
          f"{line[0] if line else '?'} ({card}); greedy tokens equal to "
          f"the in-process spec-off engine's: {got == want} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(text[-3000:], flush=True)
        fail("launch.serve --spec-draft did not serve the spec-off tokens")
    torch.cuda.empty_cache()
    return counts16


def gumbel_check(dev, V, results) -> None:
    """The sampler's Gumbel field at B=8, V=151936 on the card against
    the CPU: the Threefry bits bitwise, the field within ``TOL_GUMBEL``
    (max |Δ| over max |CPU|); its CUDA-event time."""
    from repro_torch.core import threefry
    from repro_torch.serving.sampling import _BASE_KEY_SEED, gumbel_noise
    seeds = [0, 1, 2 ** 31 - 1, 7, 123456789, 42, 2 ** 32 - 1, 5]
    pos = [0, 15, 3, 2 ** 31 - 1, 100, 9, 1, 64]

    def keys(device):
        key = threefry.fold_in(threefry.fold_in(
            threefry.prng_key(_BASE_KEY_SEED), seeds), pos)
        return tuple(torch.from_numpy(k).to(device) for k in key)
    bits_ok = torch.equal(threefry.random_bits(keys(dev), V).cpu(),
                          threefry.random_bits(keys("cpu"), V))
    g_dev = gumbel_noise(seeds, pos, V, dev)
    g_cpu = gumbel_noise(seeds, pos, V, "cpu")
    err, rel = rel_err(g_dev.cpu(), g_cpu)
    ms = Timer(dev)(lambda: gumbel_noise(seeds, pos, V, dev), iters=20)
    busy, _ = _profile(lambda: gumbel_noise(seeds, pos, V, dev), cpu=False)
    ok = bits_ok and rel <= TOL_GUMBEL
    print(f"    Gumbel field B=8 V={V}: Threefry bits card vs CPU bitwise "
          f"{bits_ok}; field max_abs_err={err:.3e} rel={rel:.2e} (tol "
          f"{TOL_GUMBEL}); {ms:.4f} ms on the card (CUDA events, median of "
          f"20, host cost included), device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'} "
          f"(profiler, one call) {'ok' if ok else 'FAIL'}", flush=True)
    results["gumbel_noise B=8"] = {"ms": ms, "max_abs_err": err}
    if not ok:
        fail("the Gumbel field on the card differs from the CPU's")


def serve_ckpt_check(model, arch_args) -> None:
    """``launch.serve.main --ckpt-dir --stream --stop`` on a params
    checkpoint of ``model.init(1)``, ``arch_args`` naming the model's
    config: its greedy tokens (cut at the stop sequence, which is request
    0's first two tokens) equal an in-process engine's on those params;
    the load time is printed."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile
    from repro_torch.launch import serve
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.sampling import match_stop
    from repro_torch.train import checkpoint as ckpt

    params1 = model.init(1)
    eng = Engine(model, params1, device=model.device, max_concurrency=4,
                 max_len=256, eos_id=-1)
    for uid, p in enumerate(serve.prompts(4, model.cfg.vocab_size)):
        eng.submit(Request(uid=uid, prompt=p,
                           sampling=SamplingParams(max_tokens=8)))
    eng.run()
    want = {r.uid: r.tokens for r in eng._done}
    del eng
    stop = tuple(want[0][:2])
    for uid, toks in want.items():
        for j in range(1, len(toks) + 1):
            if match_stop(toks[:j], (stop,)):
                want[uid] = toks[:j]
                break
    d = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        t0 = time.perf_counter()
        ckpt.save({"params": params1}, d, 1)
        t_save = time.perf_counter() - t0
        del params1
        torch.cuda.empty_cache()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(arch_args + [
                "--device", model.device.type, "--requests", "4",
                "--max-new", "8", "--ckpt-dir", d, "--stream",
                "--stop", ",".join(map(str, stop))])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    text = out.getvalue()
    got, reasons = {}, {}
    for line in text.splitlines():
        m = re.match(r"^req (\d+): (\[[^\]]*\])  \(finish=(\w+)", line)
        if m:
            got[int(m.group(1))] = json.loads(m.group(2))
            reasons[int(m.group(1))] = m.group(3)
    load = re.search(r"loaded params from \S+ \(([\d.]+)s\)", text)
    deltas = sum(1 for line in text.splitlines() if " += [" in line)
    ok = rc == 0 and got == want and reasons.get(0) == "stop" \
        and deltas > 0 and load is not None
    print(f"    launch.serve --ckpt-dir --stream --stop: save "
          f"{t_save:.2f} s, load {load.group(1) if load else '?'} s; "
          f"{deltas} streamed deltas, finish reasons {reasons}; greedy "
          f"tokens equal to the in-process engine's: {got == want} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(text[-3000:], flush=True)
        fail("launch.serve --ckpt-dir did not serve the checkpoint's tokens")


def plan_str(plan) -> str:
    """A GEMM plan or a ``dw`` plan on one line."""
    if not hasattr(plan, "bm"):
        return (f"body={plan.body} splits={plan.splits} "
                f"workspace={plan.workspace_bytes} B")
    return (f"body={plan.body} tile={plan.bm}x{plan.bn}x{plan.bk} "
            f"splits={plan.splits} workspace={plan.workspace_bytes} B "
            f"(V {plan.v_bytes}, split-K {plan.splitk_bytes})")


def bodies_str(times) -> str:
    return ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())


def dw_sweep(kernel, plan_fn, x, gy, spec, timer, splits) -> None:
    """Time a ``dw`` kernel (``element_dw`` or ``block_dw``) with each
    body forced, the tensor-core body at each count of pieces in
    ``splits``, each forced plan held to the default plan's result (the
    pieces change only the fp32 summation order)."""
    m = x.shape[0]
    want = kernel(x, gy, spec)
    times = {}
    for body, n in [("cuda_core", 1)] + [("tensor_core", n) for n in splits]:
        plan = plan_fn(m, spec, x.dtype, body=body, splits=n)
        got = kernel(x, gy, spec, plan=plan)
        torch.cuda.synchronize()
        if rel_err(got, want)[1] > TOL_DW:
            fail(f"{kernel.__name__} with a forced plan ({plan_str(plan)}) "
                 f"disagrees with the default plan")
        key = body if body == "cuda_core" else f"tensor_core splits={n}"
        times[key] = timer(lambda: kernel(x, gy, spec, plan=plan))
    print(f"      bodies forced: {bodies_str(times)}", flush=True)


def repeat_note(plan, fn, first) -> str:
    """A tensor-core or gemv product launched again must give the same
    bits."""
    if plan.body not in ("tensor_core", "gemv"):
        return ""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        fail(f"a {plan.body} GEMM is not bitwise equal to itself across "
             f"launches")
    return " bitwise across two launches=True"


def one_hot_note(THK, w, spec, v_dense, m, gen) -> str:
    """Row r of x one-hot at virtual row i_r: the element GEMM returns row
    i_r of V (``H.materialize``), bitwise."""
    rows = torch.randperm(spec.rows, generator=gen, device=w.device)[:m]
    x = torch.zeros(m, spec.rows, dtype=w.dtype, device=w.device)
    x[torch.arange(m, device=w.device), rows] = 1
    same = bool(torch.equal(THK.element_matmul(x, w, spec), v_dense[rows]))
    if not same:
        fail(f"a one-hot x at M={m} does not give rows of V bitwise")
    return " one-hot rows of V bitwise=True"


def fp32_note(THK, x, w, spec) -> str:
    """The gemv body on fp32 x and bank keeps fp32 products: within
    TOL_FP32 of the fp32 plain version."""
    x32, w32 = x.float(), w.float()
    got = THK.element_matmul(x32, w32, spec)
    _, rel = rel_err(got, THK.hashed_matmul_ref(x32, w32, spec))
    if rel > TOL_FP32:
        fail(f"the fp32 gemv body at M={x.shape[0]} is at rel {rel:.2e} of "
             f"its plain version (tol {TOL_FP32})")
    return f" fp32 rel={rel:.2e} (tol {TOL_FP32})"


def sm_clocks():
    """(current, largest) SM clock in MHz, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    now, top = (float(v) for v in out.strip().splitlines()[0].split(","))
    return now, top


def gemv_ops_per_weight(m: int, signed: bool) -> int:
    """Instructions one virtual weight of an m-row hashed GEMV needs by
    the hash's definition (csrc/common.cuh), whatever a kernel issues:
    for the bucket and, signed, for the sign, a hash of nine (the xor of
    the row and column keys, then mix32's three shifts, three xors and
    two multiplies); bucket_mod's four (multiply-high, multiply-add,
    subtract, min); the gather's address and load; the sign applied and
    the bf16 value widened to fp32; one FFMA for each row.  The issue
    term of the gemv bound."""
    return 9 * (2 if signed else 1) + 4 + 2 + (2 if signed else 1) + m


def gemv_instructions(build_mod) -> dict:
    """{row block MT: SASS instructions per virtual weight} of the gemv
    body (bf16, signed), from its product loop in the SASS (the unrolled
    K step) over the weights one iteration computes: its FFMA count over
    MT, one FFMA per row and weight; {} without cuobjdump.  Prints each
    loop's instruction mix.  A diagnostic of the kernel's overhead over
    :func:`gemv_ops_per_weight`: it sets no bound."""
    import re
    tool = _cuobjdump(build_mod)
    if not tool:
        print("    SASS: cuobjdump not available, the gemv bound counts no "
              "instructions", flush=True)
        return {}
    sass = subprocess.run([tool, "-sass", str(build_mod.lib_path(
        "hashed_matmul"))], capture_output=True, text=True,
        timeout=120).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        fname = chunk.split("\n", 1)[0].strip()
        m = re.search(r"hashed_gemvI13__nv_bfloat16Li(\d+)ELb1E", fname)
        if not m:
            continue
        size, ops = _inner_loop(chunk)
        mt = int(m.group(1))
        weights = ops.get("FFMA", 0) // mt
        if not weights:
            continue
        out[mt] = size / weights
        mix = ", ".join(f"{k} {v}" for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:12])
        print(f"    SASS gemv M<={mt}: inner loop {size} instructions for "
              f"{weights} virtual weights = {out[mt]:.2f} a weight ({mix})",
              flush=True)
    return out


def _inner_loop(chunk):
    """(instructions, {opcode: count}) of the product loop in one
    function's SASS: of the loops (backward branches) without a barrier
    (an outer loop stages x between barriers) holding the most FFMA
    instructions, the longest (the gemv body compiles one for bank values
    read from global memory only and a longer one for values held in
    shared memory, which the plan runs at qwen3-1.7b's widths)."""
    import re
    addr, ins, label = [], [], {}
    for line in chunk.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            label[m.group(1)] = len(ins)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr.append(int(m.group(1), 16))
            ins.append(m.group(2))
    at = {a: i for i, a in enumerate(addr)}
    best = (0, {})
    for i, text in enumerate(ins):
        if "BRA" not in text:
            continue
        m = re.search(r"\((\.L_x_\d+)\)", text)
        target = label.get(m.group(1)) if m else None
        if target is None:
            m = re.search(r"BRA\s+(?:`\()?0x([0-9a-f]+)", text)
            target = at.get(int(m.group(1), 16)) if m else None
        if target is None or target > i:
            continue
        ops = {}
        for t in ins[target:i + 1]:
            op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
            ops[op] = ops.get(op, 0) + 1
        if "BAR.SYNC.DEFER_BLOCKING" in ops or "BAR.SYNC" in ops:
            continue
        size, fma = i + 1 - target, ops.get("FFMA", 0)
        if (fma, size) > (best[1].get("FFMA", 0), best[0]):
            best = (size, ops)
    return best


def _cuobjdump(build_mod) -> str:
    import shutil
    tool = shutil.which("cuobjdump") or ""
    cand = Path(build_mod.nvcc_path()).with_name("cuobjdump")
    if not tool and cand.exists():
        tool = str(cand)
    if not tool:
        try:
            import triton
            cand = Path(triton.__file__).parent / "backends/nvidia/bin" \
                / "cuobjdump"
            tool = str(cand) if cand.exists() else ""
        except ImportError:
            pass
    return tool


# library -> the functions that must run on the tensor cores (name part)
TC_FUNCTIONS = {"hashed_matmul": ("tc_gemm",),
                "hashed_dw": ("tc_xtg",),
                "hashed_block": ("tc_gemm", "tc_xtg"),
                "flash_prefill": ("prefill_tc",)}


def check_sass(build_mod) -> None:
    """Count the tensor-core instructions (HGMMA, HMMA) in the SASS of the
    tensor-core functions of each library in ``TC_FUNCTIONS``, by
    function, where cuobjdump exists; fail if one of them is missing or
    has none."""
    import re
    tool = _cuobjdump(build_mod)
    if not tool:
        print("    SASS: cuobjdump not available, tensor-core instructions "
              "not counted", flush=True)
        return
    for name, wanted in TC_FUNCTIONS.items():
        sass = subprocess.run([tool, "-sass", str(build_mod.lib_path(name))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        counts = {}
        for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
            fname = chunk.split("\n", 1)[0].strip()
            counts[fname] = (chunk.count("HGMMA"),
                             len(re.findall(r"\bHMMA\b", chunk)))
        tc = {f: c for f, c in counts.items() if any(w in f for w in wanted)}
        # a mangled name from the wanted part on: kernel and template args
        short = {f: f[min(f.find(w) for w in wanted if w in f):][:32]
                 for f in tc}
        print(f"    SASS {name}: " + ", ".join(
            f"{short[f]} HGMMA={a} HMMA={b}" for f, (a, b) in tc.items())
            + f"; {len(counts) - len(tc)} other functions HGMMA="
            f"{sum(a for f, (a, _) in counts.items() if f not in tc)}",
            flush=True)
        for w in wanted:
            mine = [c for f, c in tc.items() if w in f]
            if not mine or any(a + b == 0 for a, b in mine):
                fail(f"{name}: {w} has no HGMMA/HMMA in its SASS")


def block_config(C, path: str):
    """qwen3-1.7b hashed at 1/8 by a block-mode policy (128 x 128 tiles)
    whose projections take ``path``."""
    from repro_torch import policy
    return C.get("qwen3-1.7b").policy_variant(policy.CompressionPolicy(
        mode="block", block_shape=(128, 128), path=path))


def check_counts(counts, kernels, what: str,
                 body: str = "tensor_core") -> None:
    """Every kernel of a path launched; every element GEMM of at most 16
    rows (decode: at most 8) on the gemv body and every other launch of a
    kernel that has a tensor-core body on ``body``: "tensor_core" on the
    bf16 paths at full width, "cuda_core" on the fp32 MLP path (the
    tensor-core bodies take bf16 only); every top-k with its rows
    resident in its cluster's shared memory; no plain version run on the
    card."""
    for name in kernels:
        c = counts[name]
        if c["launches"] <= 0:
            fail(f"kernel {name} was not launched on the {what} path")
        want_tc = (lambda n: n) if body == "tensor_core" else (lambda n: 0)
        if name == "hashed_matmul":
            small = c["small"]
            if c["gemv"] != small:
                fail(f"{small - c['gemv']} of the {small} element GEMMs of "
                     f"at most 16 rows on the {what} path did not run the "
                     f"gemv body")
            if c["tensor_core"] != want_tc(c["launches"] - small):
                fail(f"element GEMMs of more than 16 rows on the {what} "
                     f"path: {c['tensor_core']} of "
                     f"{c['launches'] - small} on the tensor cores, "
                     f"expected all on the {body} body")
        elif name == "topk_mask":
            if c["resident"] != c["launches"]:
                fail(f"{c['launches'] - c['resident']} top-k launches on "
                     f"the {what} path did not hold their rows in their "
                     f"cluster's shared memory")
        elif "tensor_core" in c and \
                c["tensor_core"] != want_tc(c["launches"]):
            fail(f"{name}: {c['tensor_core']} of {c['launches']} launches "
                 f"on the tensor cores on the {what} path, expected all on "
                 f"the {body} body")
    for name, c in counts.items():
        if c["plain_cuda_calls"] != 0:
            fail(f"plain version of {name} ran on the card on the {what} "
                 f"path")


def loss_and_grads(model, params, batch):
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = model.train_loss(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), tree_unflatten(params, grads)


def train_phase(label, cfg, plain_cfg, batch, n_steps, kernels):
    """Phase 6 for one mode: (a) one step's loss and bank gradients, kernel
    path against plain path; (b) ``n_steps`` AdamW steps at a constant lr
    on the repeated batch, the loss must fall; (c) the counts of (b);
    (d) step time, peak memory, a profile of one step.  Returns (the
    counts of (b), the final train state)."""
    from repro_torch import kernels as K
    from repro_torch.models import build
    from repro_torch.models.transformer import bank_spec_map
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import step as step_lib

    print(f"[6] training {cfg.name} ({label} mode): {cfg.num_layers} layers "
          f"d={cfg.d_model} {cfg.dtype} remat={cfg.remat}, B=4 S=256",
          flush=True)
    model = build(cfg, device="cuda")
    opt = opt_lib.adamw(opt_lib.constant_lr(1e-3))
    train_step = step_lib.make_train_step(model, opt, clip_norm=1.0)
    state = step_lib.init_state(model, opt, seed=0)

    # (a) kernel path against plain path, same params, same batch
    t0 = time.perf_counter()
    loss_k, grads_k = loss_and_grads(model, state["params"], batch)
    t_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_p, grads_p = loss_and_grads(build(plain_cfg, device="cuda"),
                                     state["params"], batch)
    t_p = time.perf_counter() - t0
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    print(f"    (a) loss kernel path {loss_k:.5f} plain path {loss_p:.5f}: "
          f"rel {rel_loss:.2e} (tol {TOL_LOSS}); first calls {t_k:.1f}s / "
          f"{t_p:.1f}s (kernel builds, index maps)", flush=True)
    ok = rel_loss <= TOL_LOSS
    for path in sorted(bank_spec_map(cfg)):
        gk, gp = grads_k, grads_p
        for key in path:
            gk, gp = gk[key], gp[key]
        err, rel = rel_err(gk, gp)
        cos = torch.nn.functional.cosine_similarity(
            gk.float().reshape(1, -1), gp.float().reshape(1, -1)).item()
        good = rel <= TOL_GRAD and cos >= MIN_COS
        ok = ok and good
        print(f"        grad {'.'.join(path)}: max_abs_err={err:.3e} "
              f"rel={rel:.2e} (tol {TOL_GRAD}) cos={cos:.5f} (min "
              f"{MIN_COS}) {'ok' if good else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{label}-mode training step: kernel path disagrees with the "
             f"plain path")
    del grads_k, grads_p
    torch.cuda.empty_cache()

    # (b) + (c) steps on the repeated batch, counted
    K.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(n_steps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        state, metrics = train_step(state, batch)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        losses.append(float(metrics["loss"]))
    counts = K.counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = float(np.median(times[1:]))
    print(f"    (b) losses over {n_steps} steps on one batch (AdamW lr 1e-3):"
          f" {' '.join(f'{v:.4f}' for v in losses)}", flush=True)
    print(f"    (c) launch counts over the {n_steps} steps: "
          f"{json.dumps(counts)}", flush=True)
    from repro_torch.kernels import hashed_matmul as THK
    maps = {spec: THK.element_segments(spec, "cuda") if label == "element"
            else THK.block_tables(spec, "cuda")
            for spec in bank_spec_map(cfg).values()}
    map_mib = sum(t.numel() * t.element_size() for ts in maps.values()
                  for t in ts) / 2 ** 20
    print(f"    (d) step {step_ms:.1f} ms (CUDA events, median of steps 2-"
          f"{n_steps}), peak memory {peak:.2f} GiB "
          f"(max_memory_allocated); the {len(maps)} cached {label}-mode "
          f"index maps hold {map_mib:.1f} MiB", flush=True)
    if not losses[-1] < losses[0]:
        fail(f"{label}-mode training: the loss did not fall")
    check_counts(counts, kernels, f"{label}-mode training")
    if label == "block" and counts["block_matmul"]["transposed"] <= 0:
        fail("block-mode training never ran the transposed block GEMM")
    busy, top = _profile(lambda: train_step(state, batch))
    if busy is None:
        print("    profiler: device time not measured (no CUDA events in "
              "the trace)")
    else:
        print(f"    profiler, one step: device busy {busy:.3f} ms of "
              f"{step_ms:.1f} ms (idle {1 - busy / step_ms:.0%}); by kernel "
              f"(self device ms, launches):")
        for kname, ms_, n in top:
            print(f"      {ms_:9.3f} ms {n:5d}x  {kname}")
    return counts, state


def ckpt_phase(C) -> None:
    """Phase 6, continued: checkpoint, resume and gradient compression
    through ``launch.train.run`` on qwen3-1.7b-hashed8 at full width, cut
    to 2 layers (the checkpoint is mostly the embedding's AdamW state),
    B=4 x S=256, in a temporary directory removed at the end."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile
    from repro_torch.launch import train as launch
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import grad_compress as gc
    from repro_torch.train.optimizer import tree_leaves

    cfg = C.get("qwen3-1.7b-hashed8").with_(num_layers=2)
    kw = dict(batch=4, seq=256, device="cuda", log_every=0)
    print(f"[6] checkpoint and resume: {cfg.name} cut to "
          f"{cfg.num_layers} layers, B=4 S=256, launch.train.run",
          flush=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        first = launch.run(cfg, steps=4, ckpt_dir=d, ckpt_every=2,
                           ckpt_keep=1, **kw)
        if ckpt.available_steps(d) != [4]:
            fail(f"checkpoints after 4 steps, keep=1: "
                 f"{ckpt.available_steps(d)}")
        step_dir = os.path.join(d, "step_00000004")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        t0 = time.perf_counter()
        restored = ckpt.restore(d, first["state"])
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        leaves = list(zip(tree_leaves(restored),
                          tree_leaves(first["state"])))
        same = all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in leaves)
        print(f"    4 steps, saves at 2 and 4: {nbytes} bytes a "
              f"checkpoint ({len(leaves)} leaves), saves "
              f"{', '.join(f'{t:.2f}' for t in first['save_seconds'])} s, "
              f"restore {t_restore:.2f} s; restored state bitwise equal "
              f"to the saved one: {same}", flush=True)
        if not same:
            fail("checkpoint: the restored state differs from the saved one")
        del restored, leaves, first
        torch.cuda.empty_cache()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            resumed = launch.run(cfg, steps=6, ckpt_dir=d, ckpt_every=2,
                                 ckpt_keep=1, **kw)
        print("    " + out.getvalue().strip().replace("\n", "\n    "),
              flush=True)
        if "restored checkpoint @ step 4" not in out.getvalue():
            fail("resume: no 'restored checkpoint @ step 4'")
        del resumed["state"]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    whole = launch.run(cfg, steps=6, **kw)
    del whole["state"]
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(resumed["losses"], whole["losses"][4:]))
    print(f"    resumed steps 4-5 losses "
          f"{' '.join(f'{v:.6f}' for v in resumed['losses'])} vs "
          f"uninterrupted {' '.join(f'{v:.6f}' for v in whole['losses'][4:])}"
          f": rel {rel:.2e} (tol {TOL_LOSS}); restore in the resumed run "
          f"{resumed['restore_seconds']:.2f} s", flush=True)
    if len(resumed["losses"]) != 2 or not rel <= TOL_LOSS:
        fail("resume: the resumed losses differ from an uninterrupted run")
    torch.cuda.empty_cache()

    plain_ms = 1e3 * float(np.median(whole["step_times"][1:]))
    for kind in ("hashed_space", "int8"):
        comp = launch.run(cfg, steps=3, grad_compressor=kind, **kw)
        wire = gc.wire_bytes(comp["state"]["params"], kind)
        dense = gc.wire_bytes(comp["state"]["params"], "none")
        del comp["state"]
        gc._SKETCH.clear()
        torch.cuda.empty_cache()
        l0, w0 = comp["losses"][0], whole["losses"][0]
        print(f"    {kind}: losses "
              f"{' '.join(f'{v:.6f}' for v in comp['losses'])} (first "
              f"uncompressed {w0:.6f}, bitwise equal {l0 == w0}); wire "
              f"bytes {wire} vs {dense} uncompressed; step "
              f"{1e3 * float(np.median(comp['step_times'][1:])):.1f} ms vs "
              f"{plain_ms:.1f} ms uncompressed (host clock, median of "
              f"steps 2-3 / 2-6; the first includes the sketch's tables)",
              flush=True)
        if abs(l0 - w0) > 1e-6 * abs(w0):
            fail(f"{kind}: the first step's loss differs from the "
                 f"uncompressed one (compression acts after the loss)")
        if not all(np.isfinite(comp["losses"])):
            fail(f"{kind}: a compressed step's loss is not finite")


def mlp_phase(dev, results) -> dict:
    """Phase 7: the paper's MLPs through the hashed kernels, fp32.
    Returns the launch counts of (b)."""
    from repro_torch import kernels as K
    from repro_torch.core import hashed as H
    from repro_torch.data import mnist_synthetic as D
    from repro_torch.kernels import hashed_matmul as THK
    from repro_torch.kernels import ops
    from repro_torch.paper import mlp
    from repro_torch.paper import train as T
    import torch.nn.functional as F

    print("[7] the paper's MLPs: fp32, minibatch 50, panel_cols 0",
          flush=True)
    x_np, y_np = D.load("basic", "train", n=MLP_M, seed=0)
    x = torch.from_numpy(x_np).to(dev)
    y = torch.from_numpy(y_np).to(dev)
    # (a) + (b): kernel path against plain path, counted
    counts = None
    for dims in ((784, 1000, 10), (784, 1000, 1000, 1000, 10)):
        for c in (1 / 8, 1 / 64):
            spec = mlp.MLPSpec(dims, method="hashed", compression=c,
                               dropout=0.0, input_dropout=0.0)
            params = mlp.init(spec, torch.Generator().manual_seed(0), dev)
            out = {}
            for path in ("pallas", "materialize"):
                leaves = [{k: v.detach().requires_grad_(True)
                           for k, v in p.items()} for p in params]
                K.reset_counts()
                logits = mlp.apply(spec, leaves, x, path=path)
                loss = mlp.xent(logits, y)
                loss.backward()
                torch.cuda.synchronize()
                out[path] = (logits.detach(), leaves, K.counts())
            (lk, gk, ck), (lp, gp, _) = out["pallas"], out["materialize"]
            worst = rel_err(lk, lp)[1]
            for a, b in zip(gk, gp):
                for key in a:
                    worst = max(worst, rel_err(a[key].grad, b[key].grad)[1])
            nl = spec.n_layers
            per = {n: ck[n]["launches"] for n in MLP_KERNELS}
            print(f"    {'-'.join(map(str, dims))} at 1/{round(1 / c)}: "
                  f"buckets {[spec.hashed_spec(l).num_buckets for l in range(nl)]}"
                  f"; logits and every bank and bias gradient, kernel vs "
                  f"plain: worst rel {worst:.2e} (tol {TOL_FP32}); launches "
                  f"{json.dumps(per)}", flush=True)
            if not worst <= TOL_FP32:
                fail(f"MLP {dims} at {c}: kernel path disagrees with the "
                     f"plain path")
            if per != {"hashed_matmul": nl, "hashed_matmul_t": nl - 1,
                       "hashed_dw": nl}:
                fail(f"MLP {dims} at {c}: launches {per}, expected "
                     f"{nl}/{nl - 1}/{nl} (forward/dx/dw)")
            check_counts(ck, MLP_KERNELS, f"MLP {dims}", body="cuda_core")
            counts = ck if len(dims) == 3 and c == 1 / 64 else counts
            del out, params

    # (c) the three kernels at the 1000 x 1000 layer, M = 50, 1/64
    timer = Timer(dev, host_ahead=True)
    spec = mlp.MLPSpec((784, 1000, 1000, 1000, 10), method="hashed",
                       compression=1 / 64).hashed_spec(1)
    gen = torch.Generator(device=dev).manual_seed(7)
    r, cc, m = spec.rows, spec.cols, MLP_M
    w = torch.randn(spec.num_buckets, generator=gen, device=dev) / r ** 0.5
    xa = torch.randn(m, r, generator=gen, device=dev)
    gy = torch.randn(m, cc, generator=gen, device=dev)
    pad = (0, 0, 0, (-m) % ops._pick_bm(m))   # the rows the path runs
    xp, gp_ = F.pad(xa, pad), F.pad(gy, pad)
    v = H.materialize(w, spec, dtype=torch.float32)
    ii = torch.arange(r, device=dev)[:, None]
    jj = torch.arange(cc, device=dev)[None, :]
    eidx, esgn = H.element_indices(spec, ii, jj)
    eidx, esgn = eidx.reshape(-1), esgn.reshape(-1).float()
    flops = 2.0 * m * r * cc
    cases = {
        "hashed_matmul": (
            lambda: ops.hashed_matmul(xa, w, spec),
            lambda: THK.hashed_matmul_ref(xa, w, spec),
            lambda: torch.matmul(xa, v),
            4 * (m * r + spec.num_buckets + m * cc)),
        "hashed_matmul_t": (
            lambda: THK.element_matmul_t(gp_, w, spec)[:m],
            lambda: THK.hashed_matmul_t_ref(gy, w, spec),
            lambda: torch.matmul(gy, v.t()),
            4 * (m * cc + spec.num_buckets + m * r)),
        "hashed_dw": (
            lambda: THK.element_dw(xp, gp_, spec),
            lambda: THK.hashed_dw_ref(xa, gy, spec),
            lambda: torch.zeros(spec.num_buckets, device=dev).index_add_(
                0, eidx, torch.matmul(xa.t(), gy).reshape(-1) * esgn),
            4 * (m * (r + cc) + spec.num_buckets)),
    }
    for name, (fn, plain_fn, lib_fn, nbytes) in cases.items():
        got, ref = fn(), plain_fn()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        ms, plain, lib = timer(fn), timer(plain_fn), timer(lib_fn)
        b, by = bound_ms(nbytes, flops, FP32_FLOPS)
        key = f"{name} mlp 1000x1000 M={m} fp32"
        print(f"    {key}: Kp={spec.buckets_per_panel} max_abs_err={err:.3e} "
              f"rel={rel:.2e} (tol {TOL_FP32}) "
              f"{'ok' if rel <= TOL_FP32 else 'FAIL'}  ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={b:.5f} ({by})", flush=True)
        if not rel <= TOL_FP32:
            fail(f"{key} disagrees with its plain version")
        results[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            library_ms=lib, bound_ms=b, bound_by=by)
    del timer, v, eidx, esgn

    # (d) one short fit of each method at 1/64
    xs, ys = D.load("basic", "train", n=2500, seed=0)
    xt, yt = D.load("basic", "test", n=2000, seed=1)
    cfg = T.TrainConfig(epochs=4)
    for method in ("hashed", "nn", "rer", "lrd"):
        t0 = time.perf_counter()
        res = T.run_method(method, (784, 1000, 10), 1 / 64, xs, ys, xt, yt,
                           cfg, device=dev)
        hist = res["history"]
        step_ms = float(np.median(hist["step_ms"][1:]))
        print(f"    fit {method:6s} 1/64 dims {res['dims']}: test error "
              f"{res['test_err'] * 100:.2f}%, free params "
              f"{res['free_params']}, epoch losses "
              f"{' '.join(f'{v:.4f}' for v in hist['loss'])} (means "
              f"{' '.join(f'{v:.4f}' for v in hist['mean_loss'])}), step "
              f"{step_ms:.3f} ms (CUDA events, median of "
              f"{len(hist['step_ms']) - 1}), {time.perf_counter() - t0:.1f}s"
              f" in all", flush=True)
        # the limit reads the loss the fit records for each epoch (its
        # last minibatch's, as the JAX package's fit records it): the
        # recipe's lr of 0.05 with momentum 0.9 makes the hashed net's
        # loss spike in epoch 2 before the cosine decay brings it down,
        # on the plain path too, so the epoch means need not fall
        if not hist["loss"][-1] < hist["loss"][0]:
            fail(f"MLP fit {method}: the loss did not fall")
    return counts


def _profile(fn, cpu: bool = True):
    """Device busy time of one call of ``fn`` and its top kernels, from
    ``torch.profiler``; (None, []) when the trace holds no device time.
    Only the device-side rows (kernels, copies) are summed: an operator's
    CPU-side row repeats the device time of the kernels it launched.
    ``cpu=False`` records the device alone (a whole serve run's host
    operators would only slow the trace's aggregation)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=acts + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((e.key[:70], dev_us / 1e3, e.count))
    if not rows:
        return None, []
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows[:8]


def _to_fp32(tree):
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    raise SystemExit(main())
