"""Model builder of the PyTorch port: ArchConfig -> Model.

The port of the JAX package's ``models/transformer.py`` as far as
training a decoder and serving it through the paged engine need it: the
hashed-slot inventory and policy resolution (``hash_slots``,
``slot_assignments``, ``bank_spec_map``), ``softmax_xent``, and from
``_build_decoder`` the seeded ``init``, ``train_loss``, the dense-cache
serving functions (``init_cache``, ``fwd_with_cache``, ``prefill``,
``decode_step``), ``init_paged_cache``, ``decode_paged``,
``decode_paged_block``, ``prefill_paged`` and ``logits_head``.  Params are the JAX package's nested dict with the same
leaf paths and the layer-stacked ``(L, ...)`` layout, so params carried
across with :func:`repro_torch.interop.params_from_numpy` compute the
same function.  PyTorch runs eagerly: the layer loop is a Python loop,
and the page pools are written in place (the JAX package threads them
through a ``lax.scan`` and the engine donates them).

Not ported yet: MoE, image tokens and the non-decoder kinds (ROADMAP
Queue A item 11).
"""
from __future__ import annotations

import functools
import zlib
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import policy as POL
from repro_torch.configs.base import ArchConfig
from repro_torch.core import hashed as H
from repro_torch.core.device import resolve_device
from repro_torch.core.hashing import derive_seed
from repro_torch.nn import attention as ATT
from repro_torch.nn import ffn as FFN
from repro_torch.nn import layers as L

# decode_paged_block's sublayers whose form is chosen per call: each runs
# once over the block's B*S rows ("fused") or once per slot at the decode
# step's (B, 1) shape ("slot"); attention always runs once per slot
BLOCK_SUBLAYERS = ("norm", "qkv", "qk_norm", "rope", "o", "ffn", "head")


# ---------------------------------------------------------------------------
# hashed-slot inventory + policy resolution
# ---------------------------------------------------------------------------

def _slot_seed(seed_key: str) -> int:
    # zlib.crc32, not builtin hash(): the latter is salted per process
    return derive_seed(0xC0FFEE, zlib.crc32(seed_key.encode()) & 0x7FFFFFFF)


def _not_ported(cfg: ArchConfig) -> Optional[str]:
    if cfg.arch_kind != "decoder":
        return f"arch kind {cfg.arch_kind!r}"
    if cfg.moe:
        return "MoE decoders"
    if cfg.global_every > 0:
        return "local:global attention patterns"
    if cfg.num_image_tokens > 0:
        return "image tokens"
    if cfg.norm != "rmsnorm" or cfg.activation != "swiglu":
        return f"{cfg.norm}/{cfg.activation} blocks"
    if not cfg.tie_embeddings:
        return "untied LM heads"
    return None


def hash_slots(cfg: ArchConfig) -> Tuple[POL.Slot, ...]:
    """Every hashable projection slot of a decoder, declaratively: one
    entry per param-leaf path with its dense virtual shape and hash seed
    (the JAX package's seed keys, so specs are byte-identical)."""
    if not cfg.hashed:
        return ()
    why = _not_ported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"{why}: not ported yet (ROADMAP Queue A item 11)")
    d = cfg.d_model
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    slots = []

    def add(path, seed_key, vshape, on=True):
        slots.append(POL.Slot(path=tuple(path), virtual_shape=tuple(vshape),
                              seed=_slot_seed(seed_key), default_on=on))

    add(("embed", "emb"), "embed", (cfg.padded_vocab, d),
        on=cfg.hash_embeddings)
    add(("layers", "attn", "q", "w"), "attn.q", (d, hq))
    add(("layers", "attn", "k", "w"), "attn.k", (d, hkv))
    add(("layers", "attn", "v", "w"), "attn.v", (d, hkv))
    add(("layers", "attn", "o", "w"), "attn.o", (hq, d))
    add(("layers", "ffn", "in", "w"), "ffn.in", (d, cfg.d_ff))
    add(("layers", "ffn", "gate", "w"), "ffn.gate", (d, cfg.d_ff))
    add(("layers", "ffn", "out", "w"), "ffn.out", (cfg.d_ff, d))
    return tuple(slots)


@functools.lru_cache(maxsize=128)
def slot_assignments(cfg: ArchConfig) -> Dict[tuple, POL.SlotAssignment]:
    """Policy resolution for a config: param-leaf path -> SlotAssignment."""
    return POL.resolve(POL.effective(cfg), hash_slots(cfg))


def bank_spec_map(cfg: ArchConfig) -> Dict[tuple, H.HashedSpec]:
    """Map param-leaf paths -> HashedSpec for every hashed bank."""
    return {path: a.spec for path, a in slot_assignments(cfg).items()
            if a.spec is not None}


def _slot_spec(cfg: ArchConfig, path: tuple) -> Optional[H.HashedSpec]:
    a = slot_assignments(cfg).get(tuple(path))
    return a.spec if a is not None else None


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _tree_index(tree, i: int):
    """Layer ``i`` of a layer-stacked params tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _tree_index(v, i) for k, v in tree.items()}
    return tree[i]


def _tree_unbind(tree, n: int):
    """The ``n`` layers of a layer-stacked params tree, one ``unbind`` per
    leaf: its backward stacks the layer grads into one buffer per leaf
    (indexing each layer out would add one full-size buffer per layer)."""
    if isinstance(tree, dict):
        per_key = {k: _tree_unbind(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    return torch.unbind(tree, dim=0)


def _tree_stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 vocab_size: int):
    """logits (B, S, Vp) fp32; targets (B, S) int, -1 = masked.  The
    padded vocab slots (Vp > vocab_size) are masked out of the softmax."""
    logits = logits.float()
    vp = logits.shape[-1]
    if vp > vocab_size:
        keep = torch.arange(vp, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, torch.tensor(
            -1e30, dtype=torch.float32, device=logits.device))
    mask = targets >= 0
    tgt = torch.where(mask, targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    loss = nll.sum() / denom
    acc = ((logits.argmax(-1) == tgt) & mask).sum() / denom
    return loss, {"nll": loss, "accuracy": acc, "tokens": denom}


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

class Model:
    """A decoder, trained with ``train_loss`` and served through the
    paged engine.

    ``init(seed)`` -> params; ``train_loss(params, batch)`` -> (loss,
    metrics); ``init_cache`` / ``prefill`` / ``decode_step`` run the dense
    KV cache (the engine's scratch-cache prefill), written in place;
    ``init_paged_cache(num_pages, page_size)``
    -> {"k", "v"} page pools (nl, P, ps, n_kv, hd);
    ``decode_paged`` / ``prefill_paged`` run one engine dispatch and write
    the pools in place; ``logits_head`` is the final norm + tied LM head.
    """

    def __init__(self, cfg: ArchConfig, device):
        why = _not_ported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{why}: not ported yet (ROADMAP Queue A item 11)")
        self.cfg = cfg
        self.device = device
        self.dtype = _dtype(cfg)
        sp = functools.partial(_slot_spec, cfg)
        base = ("layers", "attn")
        self.attn_plan = ATT.AttentionPlan(
            d_model=cfg.d_model, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, qk_norm=cfg.qk_norm,
            sliding_window=cfg.sliding_window, dtype=self.dtype,
            hash_q=sp(base + ("q", "w")), hash_k=sp(base + ("k", "w")),
            hash_v=sp(base + ("v", "w")), hash_o=sp(base + ("o", "w")),
            hash_path=cfg.hash_path)
        base = ("layers", "ffn")
        self.ffn_plan = FFN.FFNPlan(
            d_model=cfg.d_model, d_ff=cfg.d_ff, dtype=self.dtype, hash_in=sp(base + ("in", "w")),
            hash_gate=sp(base + ("gate", "w")),
            hash_out=sp(base + ("out", "w")), hash_path=cfg.hash_path)
        self.emb_plan = L.EmbeddingPlan(
            cfg.padded_vocab, cfg.d_model, hashed=sp(("embed", "emb")),
            dtype=self.dtype, scale_by_sqrt_dim=cfg.scale_embeddings)

    # -- params -------------------------------------------------------------
    def init(self, seed: int = 0):
        """Seeded random params: one ``torch.Generator`` on the model's
        device.  The JAX package's ``jax.random`` init cannot be
        reproduced; parity tests carry params across instead."""
        g = torch.Generator(device=self.device)
        g.manual_seed(seed)
        return self._init_tree(g, self.device)

    def init_shapes(self):
        """The params tree's leaf shapes, computed on the meta device."""
        tree = self._init_tree(None, torch.device("meta"))

        def shapes(node):
            if isinstance(node, dict):
                return {k: shapes(v) for k, v in node.items()}
            return tuple(node.shape)
        return shapes(tree)

    def empty_params(self):
        """Uninitialised params (``torch.empty``) with the params tree's
        shapes and dtypes on the model's device: a checkpoint's restore
        target."""
        tree = self._init_tree(None, torch.device("meta"))

        def empty(node):
            if isinstance(node, dict):
                return {k: empty(v) for k, v in node.items()}
            return torch.empty(node.shape, dtype=node.dtype,
                               device=self.device)
        return empty(tree)

    def _init_tree(self, g, dev):
        d = self.cfg.d_model
        params = {"embed": L.embedding_init(self.emb_plan, g, dev)}
        layers = []
        for _ in range(self.cfg.num_layers):
            layers.append({
                "attn": ATT.init(self.attn_plan, g, dev),
                "ln1": L.rmsnorm_init(d, device=dev),
                "ln2": L.rmsnorm_init(d, device=dev),
                "ffn": FFN.init(self.ffn_plan, g, dev),
            })
        params["layers"] = _tree_stack(layers)
        params["final_norm"] = L.rmsnorm_init(d, device=dev)
        return params

    def init_cache(self, batch: int, max_len: int):
        """A zero dense KV cache: {"k", "v"} (nl, B, max_len, n_kv, hd)
        and the write ``index`` (an int; ``decode_step`` also takes a
        (B,) tensor of per-row positions)."""
        shape = (self.cfg.num_layers, batch, max_len, self.cfg.num_kv_heads,
                 self.cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "index": 0}

    def init_paged_cache(self, num_pages: int, page_size: int):
        shape = (self.cfg.num_layers, num_pages, page_size,
                 self.cfg.num_kv_heads, self.cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device)}

    # -- serving dispatches --------------------------------------------------
    def _embed(self, params, tokens):
        return L.embedding_lookup(self.emb_plan, params["embed"], tokens)

    def _ffn(self, lp, x):
        h = L.rmsnorm_apply(lp["ln2"], x)
        return x + FFN.apply(self.ffn_plan, lp["ffn"], h)

    def _layer(self, lp, x, positions, cache_kv=None, cache_index=None):
        h = L.rmsnorm_apply(lp["ln1"], x)
        x = x + ATT.apply(self.attn_plan, lp["attn"], h, positions=positions,
                          cache=cache_kv, cache_index=cache_index)
        return self._ffn(lp, x)

    def embed_input(self, params, batch):
        """Token embeddings of ``batch["tokens"]``; a model with image
        tokens would prepend ``batch["image_embeds"]`` (no ported config
        has them, ROADMAP Queue A item 11), and other extras (encoder
        frames) are not read by a decoder."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.num_image_tokens > 0 and "image_embeds" in batch:
            x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
        return x

    def train_loss(self, params, batch):
        """Next-token loss of ``batch`` {"tokens", "targets"} (B, S) with
        the whole-sequence causal attention.  With ``cfg.remat`` each layer
        is recomputed in the backward pass (activation checkpointing)
        instead of keeping its intermediates.  Returns (loss, metrics)."""
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in _tree_unbind(params["layers"], self.cfg.num_layers):
            if self.cfg.remat:
                x = checkpoint(self._layer, lp, x, positions,
                               use_reentrant=False)
            else:
                x = self._layer(lp, x, positions)
        logits = self.logits_head(params, x)
        loss, metrics = softmax_xent(logits, batch["targets"],
                                     self.cfg.vocab_size)
        metrics["aux_loss"] = torch.zeros((), device=loss.device)
        return loss, metrics

    def logits_head(self, params, x):
        """Final norm + tied LM head (fp32 logits over the padded vocab)."""
        x = L.rmsnorm_apply(params["final_norm"], x)
        return L.embedding_logits(self.emb_plan, params["embed"], x)

    @torch.no_grad()
    def fwd_with_cache(self, params, x, cache, start, length=None):
        """The layers over embeddings x (B, S, d) at positions ``start +
        s`` (``start`` an int, or a (B,) tensor of per-row positions),
        writing each layer's K/V into ``cache`` in place.  With
        ``length`` (bucketed prefill: the tokens are right-padded to a
        fixed bucket) only the last real position, ``length - 1``, goes
        through the LM head (at M = 1), and the index advances by
        ``length``: the pads' K/V beyond it stay masked until decode
        overwrites them.  Returns (logits (B, S or 1, padded_vocab) fp32,
        the cache with its new index)."""
        s = x.shape[1]
        if isinstance(start, torch.Tensor) and start.dim() == 1:
            positions = start.to(device=x.device, dtype=torch.int64)[:, None] \
                + torch.arange(s, device=x.device)[None, :]
        else:
            positions = int(start) + torch.arange(s, device=x.device)
        for i in range(self.cfg.num_layers):
            lp = _tree_index(params["layers"], i)
            x = self._layer(lp, x, positions,
                            cache_kv=(cache["k"][i], cache["v"][i]),
                            cache_index=start)
        if length is not None:
            x = x[:, int(length) - 1:int(length)]
        step = s if length is None else int(length)
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "index": start + step}
        return self.logits_head(params, x), new_cache

    @torch.no_grad()
    def prefill(self, params, batch):
        """Prefill ``batch["tokens"]`` (B, S) into ``batch["cache"]`` at its
        index (``batch["length"]``: the real tokens of a padded bucket).
        Returns (last-position logits (B, 1, padded_vocab), cache)."""
        x = self.embed_input(params, batch)
        cache = batch["cache"]
        logits, cache = self.fwd_with_cache(params, x, cache, cache["index"],
                                            length=batch.get("length"))
        return logits[:, -1:, :], cache

    @torch.no_grad()
    def decode_step(self, params, tokens, cache):
        """One token a row, (B, 1), through the dense cache at its index.
        Returns (logits (B, 1, padded_vocab), cache)."""
        x = self._embed(params, tokens)
        return self.fwd_with_cache(params, x, cache, cache["index"])

    @torch.no_grad()
    def decode_paged(self, params, tokens, pages, page_table, lengths,
                     impl: str = "pallas"):
        """One continuous-batching decode step through the paged cache.

        tokens (B, 1); pages {"k","v"} (nl, P, ps, n_kv, hd), written in
        place; page_table (B, MAXP) int32 (unused slots -> trash page 0);
        lengths (B,) int32 cached-token counts EXCLUDING the current
        token.  Returns logits (B, 1, padded_vocab) fp32.
        """
        x = self._embed(params, tokens)
        for i in range(self.cfg.num_layers):
            lp = _tree_index(params["layers"], i)
            h = L.rmsnorm_apply(lp["ln1"], x)
            x = x + ATT.apply_paged(
                self.attn_plan, lp["attn"], h,
                pages=(pages["k"][i], pages["v"][i]), page_table=page_table,
                lengths=lengths, impl=impl)
            x = self._ffn(lp, x)
        return self.logits_head(params, x)

    def block_forms(self, b: int, s: int) -> Dict[str, str]:
        """The forms of ``decode_paged_block``'s sublayers at B=``b`` rows
        of S=``s`` slots that give each slot the bits of a decode step at
        B=``b``.  On the CPU every sublayer runs per slot (its vectorized
        loops split rows by size).  On the card the elementwise RoPE runs
        fused, and a projection group (q/k/v, o, the FFN) runs fused when
        every GEMM in it is the element-mode kernel on its gemv body at
        both B and B*S rows (the body's per-row arithmetic does not depend
        on M); the norms and the LM head (torch reductions and cuBLAS,
        whose layouts may follow the row count) run per slot.  chip_smoke
        measures each fused form against the steps on the card."""
        forms = {name: "slot" for name in BLOCK_SUBLAYERS}
        if self.device.type != "cuda":
            return forms
        from repro_torch.kernels.hashed_matmul import gemv_ok
        forms["rope"] = "fused"

        def gemv(plans):
            return all(p.hashed is not None and p.hashed.mode == "element"
                       and (p.hashed.exec_path or p.hash_path) == "pallas"
                       and gemv_ok(b, "element", False)
                       and gemv_ok(b * s, "element", False)
                       for p in plans)
        a, f = self.attn_plan, self.ffn_plan
        if gemv([a.lin(n) for n in ("q", "k", "v")]):
            forms["qkv"] = "fused"
        if gemv([a.lin("o")]):
            forms["o"] = "fused"
        if gemv([f.lin(n) for n in ("in", "gate", "out")]):
            forms["ffn"] = "fused"
        return forms

    @torch.no_grad()
    def decode_paged_block(self, params, tokens, pages, page_table, lengths,
                           counts, impl: str = "pallas", forms=None):
        """Multi-token paged decode for speculative propose/verify.

        tokens (B, S); slot s of row b is the token at position
        ``lengths[b] + s``, real iff ``s < counts[b]`` (padding slots
        write the trash page and give logits the caller ignores).  Pools
        are written in place.  ``forms``: a dict of sublayer -> form
        (chip_smoke measures each), by default :meth:`block_forms` (each
        slot bitwise S successive ``decode_paged`` steps).  Returns logits
        (B, S, padded_vocab) fp32."""
        b, s = tokens.shape
        if forms is None:
            forms = self.block_forms(b, s)
        x = self._embed(params, tokens)
        for i in range(self.cfg.num_layers):
            lp = _tree_index(params["layers"], i)
            h = ATT.per_slot(forms["norm"],
                             lambda t: L.rmsnorm_apply(lp["ln1"], t), x)
            x = x + ATT.apply_paged_block(
                self.attn_plan, lp["attn"], h,
                pages=(pages["k"][i], pages["v"][i]), page_table=page_table,
                lengths=lengths, counts=counts, forms=forms, impl=impl)
            h = ATT.per_slot(forms["norm"],
                             lambda t: L.rmsnorm_apply(lp["ln2"], t), x)
            x = x + ATT.per_slot(forms["ffn"], lambda t: FFN.apply(
                self.ffn_plan, lp["ffn"], t), h)
        return ATT.per_slot(forms["head"],
                            lambda t: self.logits_head(params, t), x)

    @torch.no_grad()
    def prefill_paged(self, params, tokens, pages, page_table, starts, counts,
                      write_from, impl: str = "pallas"):
        """Batched ragged prefill chunks straight into the paged cache.

        tokens (B, S); slot s of row b is the prompt token at position
        ``starts[b] + s``, real iff ``s < counts[b]``.  Fresh K/V lands in
        each row's private pages (positions below ``write_from[b]`` are
        write-protected).  Returns the LAST REAL slot's hidden state
        (B, 1, d_model): the engine runs ``logits_head`` on a per-row
        (1, 1, d) slice, keeping the sequential path's M=1 LM head.
        """
        x = self._embed(params, tokens)
        for i in range(self.cfg.num_layers):
            lp = _tree_index(params["layers"], i)
            h = L.rmsnorm_apply(lp["ln1"], x)
            x = x + ATT.apply_paged_prefill(
                self.attn_plan, lp["attn"], h,
                pages=(pages["k"][i], pages["v"][i]), page_table=page_table,
                starts=starts, counts=counts, write_from=write_from,
                impl=impl)
            x = self._ffn(lp, x)
        last = torch.clamp(counts.long() - 1, 0, tokens.shape[1] - 1)
        idx = last[:, None, None].expand(-1, 1, x.shape[-1])
        return torch.gather(x, 1, idx)


def build(cfg: ArchConfig, device=None) -> Model:
    """Model for ``cfg`` on ``device`` (default: the card; raises when
    there is none unless ``device="cpu"`` is passed)."""
    return Model(cfg, resolve_device(device))
