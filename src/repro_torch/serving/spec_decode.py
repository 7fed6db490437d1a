"""Self-speculative decoding: draft k tokens with a compressed policy
variant, verify them all in one base-model block (the PyTorch port of the
JAX package's ``serving/spec_decode.py``).

The draft model (``serving.draft``) shares the served model's hash seeds
and layout: HashedNets' ladder makes it a free byproduct of the served
weights.  Per scheduler tick, for every decoding row:

1. **Propose**: the draft catches its private paged KV up to the base's
   committed history (on admission in ragged prefill chunks of 16
   positions, ``Model.prefill_paged``; then 1-2 a tick inside the propose
   block) and samples k proposals ``d_1..d_k`` step by step.
2. **Verify**: the base model runs ``[t_last, d_1..d_k]`` as one (B, k+1)
   block through ``Model.decode_paged_block`` (each slot bitwise a
   decode step) and the fused sampler's ``run_block`` computes the token
   the baseline engine WOULD commit at every slot, with the same
   (seed, position) Threefry streams.
3. **Commit / rollback**: each row commits the verified targets up to
   the first draft mismatch (``sampling.accept_counts``); base and draft
   caches truncate back to the commit point (``truncate_row``).

**Exactness.**  The emitted tokens ARE the base sampler's own draws: slot
s counts only when the draft matched the baseline's first s tokens, and
then its logits, penalty masks and noise counter are bitwise the
baseline's.  The draft's distribution never enters the acceptance rule,
so greedy and seeded decode are token-identical to the non-speculative
engine, under preemption, prefix cache and chunked prefill too.

**Isolation.**  The draft owns a private, fully provisioned
``PagedKVCache`` with its own ``MetricsRegistry`` (sharing the engine's
would alias the ``kv.*`` / ``prefix.*`` counters): speculation never
contends with the base pool and never causes a preemption.  When the base
pool is too tight for a row's k+1 verify writes the block shrinks (down
to 1, the baseline step) instead of preempting anyone.

PyTorch runs eagerly: the JAX package's single jitted propose dispatch
(catch-up block + k sample/decode steps) is a Python loop of the same
calls here, the draft's pools written in place.

Observability: ``spec.*`` counters (proposed / accepted / dispatches), the
``spec.accept_len`` histogram, the ``spec.k_current`` and
``spec.accept_ewma`` gauges, and propose/verify/rollback tracer spans.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import ENGINE_PID, REQUEST_PID
from repro_torch.serving import sampling as sampling_lib
from repro_torch.serving.paged_cache import TRASH_PAGE, PagedKVCache

_CATCH_CHUNK = 16     # draft catch-up positions per chunk dispatch
_PROP_CATCH = 2       # catch-up slots fused into the propose step
                      # (steady state needs 1, the all-accepted bonus
                      # token makes it 2; admission pre-chunks down)


class SpecDecoder:
    """Per-engine speculative-decode driver (one per Engine)."""

    # adaptive-k controller: EWMA of the per-tick draft accept rate; raise
    # k when drafts almost always land, back off when they mostly roll
    # back.  Emitted tokens are unaffected (acceptance is equality against
    # the base sampler's own draws; k only sets how far ahead a tick tries)
    _EWMA_ALPHA = 0.3
    _K_UP_AT = 0.8        # ewma above this and k < k_max -> k += 1
    _K_DOWN_AT = 0.4      # ewma below this and k > 1     -> k -= 1

    def __init__(self, engine, draft_model, draft_params, k: int = 4, *,
                 attn_impl: str = "pallas", adaptive: bool = False):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1: {k}")
        if torch.device(draft_model.device).type != engine.device.type:
            raise ValueError(f"draft device {draft_model.device} is not the "
                             f"engine's ({engine.device})")
        self.eng = engine
        self.k_max = int(k)
        self.k = int(k)
        self.adaptive = bool(adaptive)
        self._accept_ewma: float = 0.0
        self._ewma_primed = False
        self.draft_model = draft_model
        self.draft_params = draft_params
        self.impl = attn_impl
        rows, maxp = engine.n_rows, engine.kv.maxp
        ps = engine.kv.page_size
        # fully provisioned private pool: the draft never contends with
        # the base pages and never triggers preemption
        num_pages = rows * maxp + 1
        self._kv_metrics = MetricsRegistry()
        self.kv = PagedKVCache(num_pages, ps, rows, maxp,
                               prefix_cache=False,
                               metrics=self._kv_metrics)
        self.pages = draft_model.init_paged_cache(num_pages, ps)

        m = engine.metrics
        self.counts = m.group("spec", keys=(
            "ticks", "proposed", "accepted_drafts", "rollback_tokens",
            "draft_dispatches", "verify_dispatches", "baseline_rows"))
        self._h_accept = m.histogram(
            "spec.accept_len",
            edges=tuple(float(i) for i in range(1, self.k_max + 2)))
        self._g_k = m.gauge("spec.k_current")
        self._g_k.set(self.k)
        self._g_ewma = m.gauge("spec.accept_ewma")
        self.tracer = engine.tracer

    # ------------------------------------------------------------------
    def _history(self, i: int, upto: int) -> np.ndarray:
        req = self.eng.rows[i]
        ids = np.concatenate([np.asarray(req.prompt, np.int64).ravel(),
                              np.asarray(req.tokens or [], np.int64)])
        return ids[:upto]

    def _sampler_flags(self):
        st = self.eng._sampler_state
        masks = bool(st.uses_penalties.any())
        samp = bool(st.is_sampled.any())
        trunc = samp and bool(st.uses_truncation.any())
        return masks, samp, trunc

    def _propose(self, k: int, feed, cnts, step_mask, masks, samp, trunc):
        """The draft's tick: a catch-up block of the last 1-2 history
        positions, then k sample/decode steps.  The sampling mirrors the
        base sampler (``sample_tokens``, the same (seed, pos) streams and
        penalty-mask evolution), so an identical-logits draft (the equal
        rung) reproduces the baseline's draws and accepts every slot.
        ``step_mask`` zeroes the KV writes of rows riding the batch
        without speculating this tick.  Returns proposals (B, k)."""
        dm, dp, vocab = self.draft_model, self.draft_params, \
            self.eng._vocab
        dev = self.eng.device
        st = sampling_lib.to_device(
            self.eng._sampler_state.arrays(with_masks=masks), dev)
        if masks:       # the steps update private copies of the masks
            st["seen"] = st["seen"].clone()
            st["out_seen"] = st["out_seen"].clone()
        table = self.eng._tensor(self.kv.table.astype(np.int32))
        lengths = self.eng._tensor(self.kv.lengths.astype(np.int64))
        counts = self.eng._tensor(cnts)
        logits_all = dm.decode_paged_block(dp, self.eng._tensor(feed), self.pages,
                                           table, lengths, counts, self.impl)
        rows = torch.arange(feed.shape[0], device=dev)
        logits = logits_all[rows, torch.clamp(counts.long() - 1, min=0)]
        cur = lengths + counts.long()
        smask = self.eng._tensor(step_mask).long()
        props = []
        for j in range(k):
            d = sampling_lib.sample_tokens(
                logits[:, :vocab], st, logprob_k=0, with_sampling=samp,
                with_truncation=trunc)["token"]
            props.append(d)
            if j + 1 < k:
                if masks:
                    st["seen"][rows, d] = True
                    st["out_seen"][rows, d] = True
                st["pos"] = st["pos"] + 1
                logits = dm.decode_paged_block(
                    dp, d[:, None], self.pages, table, cur, smask,
                    self.impl)[:, 0]
                cur = cur + smask
        return torch.stack(props, 1).cpu().numpy()

    # ------------------------------------------------------------------
    def tick(self, active: List[int]) -> int:
        """One propose/verify/commit round over the decode batch, in place
        of the engine's decode + sample, after its room/COW pass.  Returns
        the committed tokens."""
        eng, k = self.eng, self.k
        S = k + 1
        B = eng.n_rows
        kv_b = eng.kv

        # ---- per-row verify limits --------------------------------
        limits = np.zeros((B,), np.int64)
        elig: List[int] = []
        for i in active:
            n = int(kv_b.lengths[i])
            req = eng.rows[i]
            want = min(S, eng.max_len - n,
                       req.sampling.max_tokens - len(req.tokens))
            v = max(want, 1)
            # best-effort room for the k+1-position write block: on pool
            # pressure shrink the block (never preempt for spec)
            while v > 1 and kv_b.ensure_room(i, n + v) != "ok":
                v -= 1
            limits[i] = v
            # extras rows (image tokens) cannot be replayed from token ids
            # alone: verify-only, one baseline-equivalent token a tick
            if v >= 2 and n + k <= eng.max_len and not req.extras:
                elig.append(i)
            else:
                self.counts["baseline_rows"] += 1
        # a queued COW copy must land before the block writes
        eng._drain_cow()
        # dispatch views AFTER ensure_room extended the page tables;
        # mid-prefill rows must neither write real pages nor attend
        table, lengths = kv_b.table, kv_b.lengths
        if eng._prefilling:
            table = table.copy()
            lengths = lengths.copy()
            for i in eng._prefilling:
                table[i, :] = TRASH_PAGE
                lengths[i] = 0

        masks, samp, trunc = self._sampler_flags()
        proposals = np.zeros((B, k), np.int64)

        # ---- draft catch-up + propose (eligible rows only) --------
        if elig:
            tr0 = self.tracer.now()
            rem = np.zeros((B,), np.int64)
            hist: Dict[int, np.ndarray] = {}
            for i in elig:
                n = int(kv_b.lengths[i])
                if i not in self.kv.row_pages:
                    ok = self.kv.admit_row(i, 0)
                    assert ok, "draft pool is fully provisioned"
                st = self.kv.ensure_room(i, n + k)
                assert st == "ok", f"draft room: {st}"
                hist[i] = self._history(i, n + 1)
                rem[i] = n + 1 - int(self.kv.lengths[i])
                assert rem[i] >= 1
            while any(rem[i] > _PROP_CATCH for i in elig):
                feed = np.zeros((B, _CATCH_CHUNK), np.int64)
                cnts = np.zeros((B,), np.int32)
                for i in elig:
                    if rem[i] > _PROP_CATCH:
                        c = int(min(_CATCH_CHUNK, rem[i] - _PROP_CATCH))
                        dl = int(self.kv.lengths[i])
                        feed[i, :c] = hist[i][dl:dl + c]
                        cnts[i] = c
                # a ragged prefill of the history into the draft's pages
                # (one attention launch a layer, not one a position); no
                # token depends on the catch-up's bits
                self.draft_model.prefill_paged(
                    self.draft_params, self.eng._tensor(feed), self.pages,
                    self.eng._tensor(self.kv.table.astype(np.int32)),
                    self.eng._tensor(self.kv.lengths.astype(np.int32)),
                    self.eng._tensor(cnts), self.eng._tensor(np.zeros((B,), np.int32)),
                    self.impl)
                self.counts["draft_dispatches"] += 1
                for i in elig:
                    if cnts[i]:
                        self.kv.lengths[i] += cnts[i]
                        rem[i] -= cnts[i]
            feed = np.zeros((B, _PROP_CATCH), np.int64)
            cnts = np.zeros((B,), np.int32)
            step_mask = np.zeros((B,), np.int32)
            for i in elig:
                c = int(rem[i])
                dl = int(self.kv.lengths[i])
                feed[i, :c] = hist[i][dl:dl + c]
                cnts[i] = c
                step_mask[i] = 1
            proposals = self._propose(k, feed, cnts, step_mask, masks, samp,
                                      trunc)
            self.counts["draft_dispatches"] += 1
            self.counts["proposed"] += k * len(elig)
            for i in elig:
                # catch-up wrote `cnts` positions, steps wrote k-1 more
                self.kv.lengths[i] += int(cnts[i]) + (k - 1)
            if self.tracer.enabled:
                self.tracer.complete(ENGINE_PID, 0, "spec:propose", tr0,
                                     rows=len(elig))

        # ---- verify: one base-model block + one fused sampler -----
        tr1 = self.tracer.now()
        tokens_blk = np.zeros((B, S), np.int64)
        tokens_blk[:, 0] = eng._tokens[:, 0]
        tokens_blk[:, 1:] = proposals
        counts_v = np.zeros((B,), np.int32)
        for i in active:
            counts_v[i] = limits[i]
        logits = eng.model.decode_paged_block(
            eng.params, self.eng._tensor(tokens_blk), eng.pages,
            self.eng._tensor(table.astype(np.int32)),
            self.eng._tensor(lengths.astype(np.int64)), self.eng._tensor(counts_v),
            eng.attn_impl)
        res = eng._sampler.run_block(logits[:, :, :eng._vocab], slice(None),
                                     proposals, kind="verify")
        self.counts["verify_dispatches"] += 1
        if self.tracer.enabled:
            self.tracer.complete(ENGINE_PID, 0, "spec:verify", tr1,
                                 rows=len(active))

        # ---- accept / commit / rollback ---------------------------
        targets = res["token"].reshape(B, S)
        commits = sampling_lib.accept_counts(targets, proposals, limits)
        total = 0
        tick_accepted = 0
        for i in active:
            req = eng.rows[i]
            done = 0
            for s in range(int(commits[i])):
                kv_b.advance(i)
                eng._commit_token(i, req, res, i * S + s)
                done += 1
                if eng._stop_reason(req) is not None:
                    break
            n_new = int(kv_b.lengths[i])
            kv_b.truncate_row(i, n_new)      # free speculative pages
            rolled = int(limits[i]) - done
            if i in self.kv.row_pages:
                if self.tracer.enabled and rolled:
                    self.tracer.instant(REQUEST_PID, req.uid,
                                        "spec_rollback", tokens=rolled)
                # all accepted: the bonus target is committed but not yet
                # in any KV, so the draft re-feeds it next tick
                self.kv.truncate_row(i, min(n_new,
                                            int(self.kv.lengths[i])))
            self._h_accept.observe(done)
            if i in elig:
                self.counts["accepted_drafts"] += max(done - 1, 0)
                tick_accepted += max(done - 1, 0)
            self.counts["rollback_tokens"] += max(rolled, 0)
            total += done
        if self.adaptive and elig:
            rate = tick_accepted / (k * len(elig))
            if not self._ewma_primed:
                self._accept_ewma = rate
                self._ewma_primed = True
            else:
                a = self._EWMA_ALPHA
                self._accept_ewma = a * rate + (1 - a) * self._accept_ewma
            if self._accept_ewma > self._K_UP_AT and self.k < self.k_max:
                self.k += 1
            elif self._accept_ewma < self._K_DOWN_AT and self.k > 1:
                self.k -= 1
            self._g_k.set(self.k)
            self._g_ewma.set(round(self._accept_ewma, 6))
        self.counts["ticks"] += 1
        return total

    # ------------------------------------------------------------------
    def release_row(self, row: int) -> None:
        """Drop the row's draft pages (finish/preempt hook)."""
        if row in self.kv.row_pages:
            self.kv.release_row(row)

    def leak_check(self) -> None:
        """Refcount audit over the draft pool (Engine.shutdown)."""
        self.kv.leak_check()

    def stats(self) -> Dict[str, object]:
        proposed = int(self.counts["proposed"])
        accepted = int(self.counts["accepted_drafts"])
        return {
            "k": self.k,
            "k_max": self.k_max,
            "adaptive": self.adaptive,
            "accept_ewma": round(self._accept_ewma, 6),
            "ticks": int(self.counts["ticks"]),
            "proposed": proposed,
            "accepted_drafts": accepted,
            "accept_rate": accepted / proposed if proposed else 0.0,
            "mean_accept_len": self._h_accept.mean,
            "draft_dispatches": int(self.counts["draft_dispatches"]),
            "verify_dispatches": int(self.counts["verify_dispatches"]),
            "baseline_rows": int(self.counts["baseline_rows"]),
            "draft_pages_in_use": self.kv.alloc.num_used,
        }
