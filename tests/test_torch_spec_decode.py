"""The port's self-speculative decoding against the JAX package's.

- Draft banks: ``serving.draft`` against
  ``repro.serving.draft.derive_draft_params`` within 1e-5 (the segment
  mean's sum order); the equal rung aliases every leaf (the same
  ``data_ptr``), a deeper rung shrinks only banks; the draft policy
  round-trips through the artifact header and the registry metadata.
- ``Model.decode_paged_block`` is bitwise S successive ``decode_paged``
  steps (logits and the pages it writes) and within 1e-5 of the JAX
  package's; ``FusedSampler.run_block`` and ``accept_counts`` give the
  JAX package's tokens and counts.
- Spec-on tokens equal spec-off tokens, under
  greedy and seeded sampling with penalties, prefix cache with chunked
  prefill, preemption in a tight pool, and adaptive k (the JAX spec
  engine's tokens and counters: ``test_torch_spec_reference.py``); the
  draft pool's metrics stay private; ``Engine.from_artifact(draft_policy
  =)`` and ``launch.serve --spec-draft`` serve the same tokens.
"""
import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.models import build as jbuild
from repro.serving import draft as jdraft
from repro.serving import sampling as JS
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Request as JRequest

import repro_torch.configs as TC
from repro_torch import artifact as tart
from repro_torch import policy as TPOL
from repro_torch.artifact import format as tfmt
from repro_torch.artifact import registry as treg
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import build as tbuild
from repro_torch.serving import draft as tdraft
from repro_torch.serving import sampling as TS
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request

_REQ = re.compile(r"^req (\d+): (\[[^\]]*\])  \(finish=(\w+)")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def models():
    """Reduced hashed qwen3 (fp32, tied head, qk-norm) in both packages on
    the same params."""
    jc = jreduced(JC.get("qwen3-1.7b")).with_(
        dtype="float32").hashed_variant(0.125)
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(
        dtype="float32").hashed_variant(0.125)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jm, jp, tc, tbuild(tc, device="cpu"), tp


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# draft derivation
# ---------------------------------------------------------------------------

def test_draft_banks_match_reference(models):
    jc, _, jp, tc, _, tp = models
    _, _, jd = jdraft.build_draft(jc, jp, 1 / 16)
    dcfg, dmodel, td = tdraft.build_draft(tc, tp, "1/16")
    assert dcfg.name == f"{tc.name}-draft"
    want = jax.tree_util.tree_leaves_with_path(jd)
    got = tfmt.flatten_with_paths(td)
    assert len(want) == len(got)
    n_proj = 0
    for (jpth, a), (p, b) in zip(want, got):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape), p
        if p[-1] == "w" and p[0] == "layers":
            n_proj += 1
        np.testing.assert_allclose(_np(b), a, rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))
    assert n_proj == 7
    assert dmodel.init_shapes()["layers"]["attn"]["q"]["w"] == \
        tuple(td["layers"]["attn"]["q"]["w"].shape)


def test_equal_rung_aliases_every_leaf(models):
    _, _, _, tc, _, tp = models
    _, _, td = tdraft.build_draft(tc, tp, "1/8")
    pairs = list(zip(tfmt.flatten_with_paths(tp),
                     tfmt.flatten_with_paths(td)))
    assert pairs
    assert all(a.data_ptr() == b.data_ptr() and a is b
               for (_, a), (_, b) in pairs)


def test_deeper_rung_shrinks_only_banks(models):
    _, _, _, tc, _, tp = models
    base = tc.with_(compression=0.25, name="qwen3-reduced-hashed4")
    tp4 = tbuild(base, device="cpu").init(0)
    _, _, td = tdraft.build_draft(base, tp4, 1 / 16)
    n_alias = n_shrunk = 0
    for (pb, b), (pd, d) in zip(tfmt.flatten_with_paths(tp4),
                                tfmt.flatten_with_paths(td)):
        assert pb == pd
        if d is b:
            n_alias += 1
        else:
            assert d.numel() < b.numel() and pb[-1] == "w", pb
            n_shrunk += 1
    assert n_alias > 0 and n_shrunk == 7


def test_draft_policy_roundtrips_header_and_registry(tmp_path):
    pol = TPOL.CompressionPolicy(
        rules=(TPOL.PolicyRule(match="layers.attn.*", compression=0.25),),
        compression=0.125)
    cfg = TC.reduced(TC.get("qwen3-1.7b")).with_(
        dtype="float32").policy_variant(pol)
    path = str(tmp_path / "draft.hnart")
    tart.export_model(path, cfg, tbuild(cfg, device="cpu").init(0))
    header = tfmt.read_header(path)
    cfg2 = tfmt.config_from_dict(header["config"])
    assert cfg2 == cfg and TPOL.effective(cfg2) == pol
    assert tart.load_model(path, device="cpu")[0] == \
        tart.io.with_exec_path(cfg, "pallas")
    assert TPOL.policy_from_dict(header["config"]["hash_policy"],
                                 strict=False) == pol
    root = str(tmp_path / "reg")
    treg.register(root, "toy", path,
                  metadata={"draft_policy": TPOL.policy_to_dict(pol)})
    e = treg.resolve(root, "toy")
    assert TPOL.policy_from_dict(e["metadata"]["draft_policy"]) == pol
    assert tdraft.resolve_draft_policy(pol, cfg) is pol


# ---------------------------------------------------------------------------
# the verify block against the decode step
# ---------------------------------------------------------------------------

def _prefilled(model, params, feeds, ps=8, maxp=8):
    b = len(feeds)
    pages = model.init_paged_cache(b * maxp + 1, ps)
    table = torch.arange(1, b * maxp + 1, dtype=torch.int32).reshape(b, maxp)
    smax = max(len(f) for f in feeds)
    toks = torch.zeros((b, smax), dtype=torch.int64)
    for i, f in enumerate(feeds):
        toks[i, :len(f)] = torch.from_numpy(f)
    cnt = torch.tensor([len(f) for f in feeds], dtype=torch.int32)
    zeros = torch.zeros(b, dtype=torch.int32)
    model.prefill_paged(params, toks, pages, table, zeros, cnt, zeros)
    return pages, table, cnt


def test_decode_paged_block_bitwise_steps_and_reference(models):
    jc, jm, jp, tc, tm, tp = models
    rng = np.random.default_rng(3)
    feeds = [rng.integers(2, tc.vocab_size, n).astype(np.int64)
             for n in (5, 11, 8, 3)]
    S = 4
    blk = torch.from_numpy(rng.integers(2, tc.vocab_size, (4, S)))
    counts = torch.tensor([4, 4, 2, 4], dtype=torch.int32)
    pages, table, lengths = _prefilled(tm, tp, feeds)
    pages_b = {k: v.clone() for k, v in pages.items()}
    got = tm.decode_paged_block(tp, blk, pages_b, table, lengths, counts)
    for s in range(S):
        step = tm.decode_paged(tp, blk[:, s:s + 1], pages, table,
                               lengths + s)
        for i in range(4):
            if s < counts[i]:
                assert torch.equal(got[i, s], step[i, 0]), (i, s)
    # every real slot's K/V lands where the steps put it
    for i in range(4):
        n = int(lengths[i]) + int(counts[i])
        for k in ("k", "v"):
            pos = table[i].long().repeat_interleave(8)[:n]
            off = torch.arange(n) % 8
            assert torch.equal(pages_b[k][:, pos, off], pages[k][:, pos, off])
    assert set(tm.block_forms(4, S).values()) == {"slot"}     # on the CPU
    # the JAX package's block on the same pages
    pj, _, _ = _prefilled(tm, tp, feeds)
    jpages = {k: jnp.asarray(_np(v)) for k, v in pj.items()}
    want, _ = jm.decode_paged_block(jp, jnp.asarray(_np(blk), jnp.int32),
                                    jpages, jnp.asarray(_np(table)),
                                    jnp.asarray(_np(lengths)),
                                    jnp.asarray(_np(counts)))
    want = np.asarray(want)
    for i in range(4):
        c = int(counts[i])
        np.testing.assert_allclose(_np(got[i, :c]), want[i, :c],
                                   rtol=1e-5, atol=1e-5)


def _bind(state_cls, req_cls, sp_cls, rows, vocab):
    st = state_cls
    reqs = [req_cls(uid=0, prompt=np.array([3, 5, 7], np.int32),
                    sampling=sp_cls(max_tokens=8)),
            req_cls(uid=1, prompt=np.array([9, 4], np.int32),
                    sampling=sp_cls(temperature=0.8, top_k=12, seed=5,
                                    max_tokens=8)),
            req_cls(uid=2, prompt=np.array([2, 2, 6], np.int32),
                    sampling=sp_cls(temperature=0.7, top_p=0.9, seed=9,
                                    repetition_penalty=1.3,
                                    presence_penalty=0.4, max_tokens=8))]
    for i, r in enumerate(reqs[:rows]):
        r.tokens = [11, 13][:i]
        r.seed_used = r.sampling.seed
        st.bind(i, r)
    return st


def test_run_block_and_accept_counts_match_reference():
    rng = np.random.default_rng(0)
    R, S, V = 3, 4, 64
    logits = rng.standard_normal((R, S, V)).astype(np.float32) * 3
    proposals = rng.integers(0, V, (R, S - 1))
    js = JS.FusedSampler(R, V, 4)
    ts = TS.FusedSampler(R, V, 4)
    _bind(js.state, JRequest, JSP, R, V)
    _bind(ts.state, Request, SamplingParams, R, V)
    want = js.run_block(jnp.asarray(logits), slice(None), proposals)
    got = ts.run_block(torch.from_numpy(logits), slice(None), proposals)
    np.testing.assert_array_equal(got["token"], np.asarray(want["token"]))
    np.testing.assert_allclose(got["logprob"], np.asarray(want["logprob"]),
                               rtol=1e-5, atol=1e-5)
    assert ts.dispatches["verify"] == 1
    # slot s of the block is the baseline call after s commits
    for s in range(S):
        one = TS.FusedSampler(R, V, 4)
        _bind(one.state, Request, SamplingParams, R, V)
        for r in range(R):
            for t in proposals[r, :s]:
                one.state.note(r, int(t))
        res = one.run(torch.from_numpy(logits[:, s]), slice(None), "decode")
        np.testing.assert_array_equal(res["token"], got["token"][s::S])
    targets = rng.integers(0, 3, (6, S))
    props = rng.integers(0, 3, (6, S - 1))
    limits = np.array([4, 4, 1, 2, 3, 4])
    np.testing.assert_array_equal(
        TS.accept_counts(targets, props, limits),
        JS.accept_counts(targets, props, limits))


# ---------------------------------------------------------------------------
# engines: spec on == spec off
# ---------------------------------------------------------------------------

MODES = {
    "greedy-seeded": dict(max_concurrency=3, page_size=8),
    "prefix-chunked": dict(max_concurrency=3, page_size=8,
                           prefix_cache=True, prefill_chunk=8),
    "tight-pool": dict(max_concurrency=3, page_size=4, num_pages=14),
    "adaptive": dict(max_concurrency=3, page_size=8, spec_adaptive=True),
}


def work(vocab, n=5, max_tokens=8):
    """Greedy, seeded (top-k, top-p) and penalized requests, two sharing a
    12-token prefix."""
    rng = np.random.default_rng(2)
    shared = rng.integers(2, vocab, 12).astype(np.int32)
    out = []
    for uid in range(n):
        p = rng.integers(2, vocab, int(rng.integers(3, 18))).astype(np.int32)
        if uid in (2, 4):
            p = np.concatenate([shared, p[:4]])
        if uid % 3 == 1:
            sp = dict(temperature=0.8, top_k=20, seed=uid,
                      max_tokens=max_tokens)
        elif uid == 2:
            sp = dict(temperature=0.6, top_p=0.9, seed=11,
                      repetition_penalty=1.2, max_tokens=max_tokens)
        else:
            sp = dict(max_tokens=max_tokens)
        out.append((uid, p, sp))
    return out


def run(eng, req_cls, sp_cls, requests):
    for uid, p, sp in requests:
        assert eng.submit(req_cls(uid=uid, prompt=p.copy(),
                                  sampling=sp_cls(**sp)))
    eng.run()
    eng.kv.leak_check()
    if eng.spec is not None:
        eng.spec.leak_check()
        assert eng.spec.kv.alloc.num_used == 0
    return {r.uid: list(r.tokens) for r in eng._done}


@pytest.fixture(scope="module")
def draft16(models):
    _, _, _, tc, _, tp = models
    _, dm, dp = tdraft.build_draft(tc, tp, "1/16")
    return dm, dp


@pytest.mark.parametrize("mode", list(MODES))
def test_spec_tokens_equal_spec_off(models, draft16, mode):
    _, _, _, tc, tm, tp = models
    requests = work(tc.vocab_size)
    kw = dict(max_len=64, eos_id=-1, **MODES[mode])
    adaptive = kw.pop("spec_adaptive", False)
    off_eng = Engine(tm, tp, device="cpu", **kw)
    off = run(off_eng, Request, SamplingParams, requests)
    eng = Engine(tm, tp, device="cpu", draft=draft16, spec_k=3,
                 spec_adaptive=adaptive, **kw)
    assert run(eng, Request, SamplingParams, requests) == off
    assert all(len(t) == 8 for t in off.values())
    st = eng.stats()
    assert st["spec"]["verify_dispatches"] > 0 and st["spec"]["proposed"] > 0
    assert eng.metrics.snapshot()["spec.rollback_tokens"] > 0
    if mode == "tight-pool":
        assert st["preemptions"] > 0
    if mode == "prefix-chunked":
        assert st["hit_tokens"] > 0
    if mode == "adaptive":
        assert st["spec"]["adaptive"] and st["spec"]["k"] < 3


def test_spec_metrics_in_main_registry_draft_pool_private(models):
    _, _, _, tc, tm, tp = models
    _, dm, dp = tdraft.build_draft(tc, tp, "1/8")
    eng = Engine(tm, tp, device="cpu", max_concurrency=2, max_len=64,
                 eos_id=-1, page_size=8, draft=(dm, dp), spec_k=3)
    rng = np.random.default_rng(1)
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=rng.integers(
            2, tc.vocab_size, 6).astype(np.int32), max_new_tokens=5))
    eng.run()
    snap = eng.metrics.snapshot()
    for name in ("spec.ticks", "spec.proposed", "spec.accepted_drafts",
                 "spec.rollback_tokens", "spec.draft_dispatches",
                 "spec.verify_dispatches", "spec.accept_len",
                 "spec.k_current"):
        assert name in snap, name
    assert snap["spec.accept_len"]["count"] > 0
    assert eng.spec._kv_metrics is not eng.metrics
    assert "kv.pages_fresh" in eng.spec._kv_metrics.snapshot()
    st = eng.stats()["spec"]
    assert st["ticks"] == snap["spec.ticks"]
    # the equal rung proposes the baseline's own tokens
    assert st["accept_rate"] == 1.0


def test_from_artifact_draft_and_serve_launcher(models, tmp_path):
    _, _, _, tc, tm, tp = models
    path = str(tmp_path / "m.hnart")
    tart.export_model(path, tc, tp)
    root = str(tmp_path / "reg")
    treg.register(root, "toy", path)
    requests = work(tc.vocab_size, n=3, max_tokens=6)
    kw = dict(slots=2, max_len=64, eos_id=-1, page_size=8, device="cpu")
    base = run(Engine.from_artifact("toy", registry_root=root, **kw),
               Request, SamplingParams, requests)
    eng = Engine.from_artifact("toy", registry_root=root,
                               draft_policy="1/16", spec_k=3, **kw)
    assert run(eng, Request, SamplingParams, requests) == base
    assert eng.stats()["spec"]["verify_dispatches"] > 0

    def launch(extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--artifact", path, "--device", "cpu",
                             "--requests", "2", "--max-new", "5",
                             "--temperature", "0.8", "--seed", "4"] + extra)
        got = {int(m.group(1)): json.loads(m.group(2))
               for m in map(_REQ.match, out.getvalue().splitlines()) if m}
        return rc, got, out.getvalue()
    rc0, off, _ = launch([])
    assert rc0 == 0 and len(off) == 2
    for extra in ([], ["--spec-adaptive"]):
        rc1, on, text = launch(["--spec-draft", "1/16", "--spec-k", "3"]
                               + extra)
        assert rc1 == 0 and on == off
        assert re.search(r"spec decode: accept_rate=[\d.]+ ", text), \
            text[-2000:]
