"""Fused batched sampling for the serving engine (PyTorch port of the JAX
package's ``serving/sampling.py``).

One call per decode tick covers the whole decode batch, however many
distinct ``SamplingParams`` are in flight: every knob is a per-row
tensor.  The stages, in order:

1. **Penalties** — repetition (divide/multiply on tokens seen in
   prompt+output) and presence (subtract on generated tokens); the
   defaults (1.0 / 0.0) are exact no-ops.
2. **Logprob surface** — ``log_softmax`` of the penalized,
   un-temperature-scaled logits.
3. **Temperature -> top-k -> top-p -> min-p** truncation.  Top-k is the
   radix-select kernel (``kernels.topk``; its plain version on the CPU).
4. **Gumbel-argmax sampling** with noise that is a pure function of
   (request seed, generated-token index): row b's field is
   ``jax.random.gumbel`` of the key ``fold_in(fold_in(PRNGKey(20150406),
   seed[b]), pos[b])``, drawn by the port's own Threefry
   (``core.threefry``), so a seeded request samples the JAX engine's
   tokens, and preemption-recompute and prefix-cache replay reproduce
   every draw.  Greedy rows (temperature 0) take ``argmax`` of the
   penalized logits.

``SamplerState`` (host-side per-row knob mirror) and ``FusedSampler``
(dispatch surface + ``sampler.*`` metrics) keep the JAX package's
behaviour and metric names.  The speculative-verify surface
(``run_block``) comes with spec decode (ROADMAP Queue A item 8).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.kernels.topk import NEG, topk_mask
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import ENGINE_PID, Tracer

# Fixed base of the per-request noise streams; changing it changes every
# sampled (temperature > 0) output.
_BASE_KEY_SEED = 20150406        # HashedNets (ICML 2015)


def apply_penalties(logits, seen, out_seen, rep_pen, pres_pen):
    """Repetition + presence penalties, rows vectorized.

    logits (B, V) fp32; seen/out_seen (B, V) bool; rep_pen/pres_pen (B,).
    Defaults (1.0, 0.0) are exact no-ops bit-for-bit."""
    r = rep_pen[:, None]
    pen = torch.where(logits > 0, logits / r, logits * r)
    x = torch.where(seen, pen, logits)
    return x - pres_pen[:, None] * out_seen.to(x.dtype)


def topp_mask(z, p, fill=NEG):
    """Nucleus filtering: keep the smallest descending-probability prefix
    with mass >= p (a token survives iff the mass of strictly
    higher-ranked tokens is < p), then every token tying the cutoff.
    ``p >= 1`` disables the row."""
    probs = torch.softmax(z.float(), dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True).values
    excl = torch.cat([torch.zeros_like(srt[:, :1]),
                      torch.cumsum(srt, dim=-1)[:, :-1]], dim=-1)
    keep_srt = excl < p[:, None]
    cutoff = torch.amin(torch.where(keep_srt, srt, 2.0), dim=-1)
    keep = (probs >= cutoff[:, None]) | (p >= 1.0)[:, None]
    return torch.where(keep, z, torch.tensor(fill, dtype=z.dtype,
                                             device=z.device))


def minp_mask(z, min_p, fill=NEG):
    """Drop tokens with probability < ``min_p * max_prob`` (0 disables)."""
    probs = torch.softmax(z.float(), dim=-1)
    mx = torch.amax(probs, dim=-1, keepdim=True)
    keep = (probs >= min_p[:, None] * mx) | (min_p <= 0.0)[:, None]
    return torch.where(keep, z, torch.tensor(fill, dtype=z.dtype,
                                             device=z.device))


def gumbel_noise(seeds, positions, vocab: int, device,
                 rows: Optional[List[int]] = None) -> torch.Tensor:
    """(B, vocab) Gumbel field, row b drawn from the key
    ``fold_in(fold_in(PRNGKey(20150406), seeds[b]), positions[b])`` as
    the JAX package's ``_row_key`` makes it.  Only ``rows`` (default all)
    are drawn, together: their keys on the host, their fields on
    ``device``.  The others are zeros (greedy rows never read theirs)."""
    b = len(seeds)
    rows = list(range(b)) if rows is None else list(rows)
    g = torch.zeros((b, vocab), dtype=torch.float32, device=device)
    if not rows:
        return g
    key = threefry.fold_in(threefry.prng_key(_BASE_KEY_SEED),
                           [int(seeds[i]) for i in rows])
    key = threefry.fold_in(key, [int(positions[i]) for i in rows])
    k1, k2 = torch.from_numpy(np.stack(key)).to(device)
    g[torch.tensor(rows, device=device)] = threefry.gumbel((k1, k2), vocab)
    return g


def sample_tokens(logits, state, *, logprob_k: int = 0,
                  with_sampling: bool = True, with_truncation: bool = True,
                  noise: Optional[torch.Tensor] = None):
    """One fused sampling call for a batch of rows.

    logits: (B, V); state: dict of per-row tensors on the logits' device —
    temperature/top_p/min_p/rep_pen/pres_pen (B,) f32, top_k/seed/pos
    (B,) int, and optionally seen/out_seen (B, V) bool (omitting them
    skips the penalty stage, exact for default-penalty batches).
    ``with_sampling=False`` is the all-greedy specialization;
    ``with_truncation=False`` skips top-k/top-p/min-p (exact when every
    row has them disabled).  ``noise``: an optional (B, V) Gumbel field;
    by default it is drawn per sampled row from (seed, pos).
    Returns {"token" (B,) int64, "logprob" (B,) f32} plus, when
    ``logprob_k > 0``, {"topk_ids" (B, K), "topk_logprobs" (B, K)}.
    """
    x = logits.float()
    if "seen" in state:
        pen = apply_penalties(x, state["seen"], state["out_seen"],
                              state["rep_pen"], state["pres_pen"])
    else:
        pen = x
    lp = torch.log_softmax(pen, dim=-1)
    greedy_tok = torch.argmax(pen, dim=-1)

    t = state["temperature"]
    if with_sampling:
        z = pen / torch.clamp(t, min=1e-6)[:, None]
        if with_truncation:
            z = topk_mask(z, state["top_k"], fill=NEG)
            z = topp_mask(z, state["top_p"])
            z = minp_mask(z, state["min_p"])
        if noise is None:
            rows = [i for i, ti in enumerate(t.tolist()) if ti > 0.0]
            noise = gumbel_noise(state["seed"].tolist(),
                                 state["pos"].tolist(), x.shape[-1],
                                 x.device, rows)
        sampled_tok = torch.argmax(z + noise, dim=-1)
        tok = torch.where(t <= 0.0, greedy_tok, sampled_tok)
    else:
        tok = greedy_tok
    out = {"token": tok,
           "logprob": torch.gather(lp, 1, tok[:, None])[:, 0]}
    if logprob_k > 0:
        top_lp, top_ids = torch.topk(lp, logprob_k, dim=-1)
        out["topk_ids"] = top_ids
        out["topk_logprobs"] = top_lp
    return out


class SamplerState:
    """Host-side per-row sampling state for a fixed decode batch.

    ``bind`` reconstructs a slot from the request's (sampling params,
    prompt, tokens-so-far) — a pure function of request state, so a
    preempted request rebinds to the identical state; ``note`` advances
    a slot by one committed token; ``batch`` returns the arrays
    ``sample_tokens`` consumes.
    """

    def __init__(self, rows: int, vocab: int):
        self.rows, self.vocab = rows, vocab
        self.temperature = np.zeros((rows,), np.float32)
        self.top_k = np.zeros((rows,), np.int32)
        self.top_p = np.ones((rows,), np.float32)
        self.min_p = np.zeros((rows,), np.float32)
        self.rep_pen = np.ones((rows,), np.float32)
        self.pres_pen = np.zeros((rows,), np.float32)
        self.seed = np.zeros((rows,), np.int64)
        self.pos = np.zeros((rows,), np.int64)
        self.seen = np.zeros((rows, vocab), bool)
        self.out_seen = np.zeros((rows, vocab), bool)
        self.uses_penalties = np.zeros((rows,), bool)
        self.wants_logprobs = np.zeros((rows,), bool)
        self.is_sampled = np.zeros((rows,), bool)
        self.uses_truncation = np.zeros((rows,), bool)

    def _ids_in_vocab(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64).ravel()
        return ids[(ids >= 0) & (ids < self.vocab)]

    def bind(self, row: int, req) -> None:
        sp = req.sampling
        self.temperature[row] = sp.temperature
        self.top_k[row] = sp.top_k
        self.top_p[row] = sp.top_p
        self.min_p[row] = sp.min_p
        self.rep_pen[row] = sp.repetition_penalty
        self.pres_pen[row] = sp.presence_penalty
        self.seed[row] = int(req.seed_used or 0) & 0xFFFFFFFF
        self.uses_penalties[row] = (sp.repetition_penalty != 1.0
                                    or sp.presence_penalty != 0.0)
        self.wants_logprobs[row] = sp.logprobs is not None
        self.is_sampled[row] = sp.temperature > 0.0
        self.uses_truncation[row] = (sp.top_k > 0 or sp.top_p < 1.0
                                     or sp.min_p > 0.0)
        toks = list(req.tokens or ())
        self.pos[row] = len(toks)
        self.seen[row] = False
        self.out_seen[row] = False
        self.seen[row, self._ids_in_vocab(req.prompt)] = True
        if toks:
            gen = self._ids_in_vocab(toks)
            self.seen[row, gen] = True
            self.out_seen[row, gen] = True

    def clear(self, row: int) -> None:
        self.temperature[row] = 0.0
        self.top_k[row] = 0
        self.top_p[row] = 1.0
        self.min_p[row] = 0.0
        self.rep_pen[row] = 1.0
        self.pres_pen[row] = 0.0
        self.seed[row] = 0
        self.pos[row] = 0
        self.seen[row] = False
        self.out_seen[row] = False
        self.uses_penalties[row] = False
        self.wants_logprobs[row] = False
        self.is_sampled[row] = False
        self.uses_truncation[row] = False

    def note(self, row: int, tok: int) -> None:
        """Advance one committed token: the noise counter moves, and the
        penalty masks absorb the new token."""
        self.pos[row] += 1
        if 0 <= tok < self.vocab:
            self.seen[row, tok] = True
            self.out_seen[row, tok] = True

    def batch(self, sl: slice = slice(None), *, with_masks: bool = True,
              device="cpu") -> Dict[str, torch.Tensor]:
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a[sl])).to(device)
        out = {"temperature": t(self.temperature), "top_k": t(self.top_k),
               "top_p": t(self.top_p), "min_p": t(self.min_p),
               "rep_pen": t(self.rep_pen), "pres_pen": t(self.pres_pen),
               "seed": t(self.seed), "pos": t(self.pos)}
        if with_masks:
            out["seen"] = t(self.seen)
            out["out_seen"] = t(self.out_seen)
        return out


class FusedSampler:
    """The engine-facing sampler: the per-row ``SamplerState``, the choice
    of the cheapest exact specialization per call (no top-K logprobs
    unless a bound row asked, argmax only for all-greedy batches, no
    truncation stages for temperature-only batches, no penalty masks
    for default-penalty batches), and the ``sampler.dispatches.*``
    counters and ``sampler.dispatch_s`` histogram."""

    def __init__(self, rows: int, vocab: int, logprob_k: int = 8, *,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        m = metrics if metrics is not None else MetricsRegistry()
        self.state = SamplerState(rows, vocab)
        self.logprob_k = int(min(logprob_k, vocab))
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.dispatches = m.group("sampler.dispatches",
                                  keys=("prefill", "decode", "verify"))
        self._h_dispatch = m.histogram("sampler.dispatch_s")

    @property
    def time_s(self) -> float:
        """Cumulative seconds spent inside sampler calls."""
        return self._h_dispatch.total

    def run(self, logits: torch.Tensor, sl: slice,
            kind: str) -> Dict[str, np.ndarray]:
        """One fused call over the row slice ``sl`` of the state (the full
        batch for decode ticks, the single admitted row for a prefill
        completion).  ``logits`` (rows, vocab)."""
        logits = logits.float()
        if logits.is_cuda:
            # finish the model's queued work before the clock starts, so
            # sampler.dispatch_s measures the sampler alone
            torch.cuda.synchronize(logits.device)
        t0 = time.perf_counter()
        tr0 = self.tracer.now()
        st = self.state
        masks = bool(st.uses_penalties[sl].any())
        k = self.logprob_k if st.wants_logprobs[sl].any() else 0
        samp = bool(st.is_sampled[sl].any())
        trunc = samp and bool(st.uses_truncation[sl].any())
        out = sample_tokens(
            logits, st.batch(sl, with_masks=masks, device=logits.device),
            logprob_k=k, with_sampling=samp, with_truncation=trunc)
        res = {k2: v.cpu().numpy() for k2, v in out.items()}
        self._h_dispatch.observe(time.perf_counter() - t0)
        self.dispatches[kind] += 1
        if self.tracer.enabled:
            self.tracer.complete(ENGINE_PID, 0, f"sampler:{kind}", tr0)
        return res


def match_stop(tokens: List[int], stop) -> bool:
    """True when ``tokens`` ends with any of the stop sequences."""
    for seq in stop:
        n = len(seq)
        if n and len(tokens) >= n and tuple(tokens[-n:]) == tuple(seq):
            return True
    return False
