"""PyTorch port vs the JAX package: the decoder's paged serving paths.

The serving bench's two models (``benchmarks/serving_bench.py``:
``reduced(qwen3-1.7b)`` in fp32, dense and ``hashed_variant(0.125)``),
and the same hashed at 1/8 in block mode (32 x 32 tiles), with params
carried across as numpy.  A ragged batched prefill into the
paged pool, the M=1 LM head, then two decode steps: hidden states,
logits and the written pages must agree within atol 1e-4 (fp32; the two
packages sum in another order, and the reference itself misses its own
fp32 bitwise pins by ~1.5e-6 on this toolchain), and greedy argmax ids
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.models import build as jbuild

import repro_torch.configs as TC
from repro_torch.interop import params_from_numpy
from repro_torch.models import build as tbuild

ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(kind: str):
    jc = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32")
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32")
    if kind == "element":
        jc, tc = jc.hashed_variant(0.125), tc.hashed_variant(0.125)
    elif kind == "block":
        # (32, 32) tiles divide every reduced shape (64, 32, 128)
        jc = jc.hashed_variant(0.125, mode="block").with_(hash_block=(32, 32))
        tc = tc.hashed_variant(0.125, mode="block").with_(hash_block=(32, 32))
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(1))
    tm = tbuild(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("kind", ["dense", "element", "block"],
                         ids=["qwen3-reduced-dense", "qwen3-reduced-hashed",
                              "qwen3-reduced-block"])
@pytest.mark.parametrize("impl", ["pallas", "ref"])
def test_paged_prefill_and_decode_match_reference(kind, impl):
    jm, jp, tm, tp = _pair(kind)
    cfg = jm.cfg
    rng = np.random.default_rng(7)
    ps, maxp, npages = 4, 6, 20
    table = np.array([[1, 2, 3, 4, 0, 0], [5, 6, 7, 8, 9, 0],
                      [0, 0, 0, 0, 0, 0], [10, 11, 12, 13, 0, 0]], np.int32)
    s = 8
    toks = rng.integers(2, cfg.vocab_size, size=(4, s)).astype(np.int32)
    starts = np.array([0, 0, 0, 0], np.int32)
    counts = np.array([8, 5, 0, 7], np.int32)
    wfrom = np.zeros(4, np.int32)

    jpages = jm.init_paged_cache(npages, ps)
    jx, jpages = jm.prefill_paged(
        jp, jnp.asarray(toks), jpages, jnp.asarray(table),
        jnp.asarray(starts), jnp.asarray(counts), jnp.asarray(wfrom),
        impl="ref")
    tpages = tm.init_paged_cache(npages, ps)
    tx = tm.prefill_paged(
        tp, torch.from_numpy(toks).long(), tpages, torch.from_numpy(table),
        torch.from_numpy(starts), torch.from_numpy(counts),
        torch.from_numpy(wfrom), impl=impl)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    # the engine's per-row M=1 LM head
    for r in (0, 1, 3):
        jl = np.asarray(jm.logits_head(jp, jx[r:r + 1]))
        tl = tm.logits_head(tp, tx[r:r + 1]).numpy()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        assert tl.argmax(-1).tolist() == jl.argmax(-1).tolist()

    lengths = counts.copy()
    nxt = rng.integers(2, cfg.vocab_size, size=(4, 1)).astype(np.int32)
    for _ in range(2):
        jl, jpages = jm.decode_paged(jp, jnp.asarray(nxt), jpages,
                                     jnp.asarray(table), jnp.asarray(lengths),
                                     impl="ref")
        tl = tm.decode_paged(tp, torch.from_numpy(nxt).long(), tpages,
                             torch.from_numpy(table),
                             torch.from_numpy(lengths), impl=impl)
        jl, tl = np.asarray(jl), tl.numpy()
        np.testing.assert_allclose(tl, jl, rtol=0, atol=ATOL)
        greedy = jl[:, 0].argmax(-1)
        assert tl[:, 0].argmax(-1).tolist() == greedy.tolist()
        nxt = greedy[:, None].astype(np.int32)
        lengths = lengths + 1
    # pages (row 2 is idle: its writes land in the trash page 0, which
    # nothing reads; compare the live pages)
    for k in ("k", "v"):
        np.testing.assert_allclose(tpages[k][:, 1:].numpy(),
                                   np.asarray(jpages[k])[:, 1:],
                                   rtol=0, atol=ATOL)


def test_params_from_numpy_checks_leaf_paths_and_shapes():
    jc = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32")
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32")
    tree = jax.tree.map(np.asarray, jbuild(jc).init(jax.random.PRNGKey(0)))
    assert params_from_numpy(tree, tc, device="cpu")["layers"]["attn"]["q"][
        "w"].shape == (2, 64, 64)
    bad = dict(tree, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_numpy(bad, tc, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "embed"},
                          tc, device="cpu")


def test_seeded_init_is_reproducible_and_shaped_like_reference():
    tc = TC.reduced(TC.get("qwen3-1.7b")).hashed_variant(0.125)
    tm = tbuild(tc, device="cpu")
    a, b = tm.init(3), tm.init(3)
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jax.eval_shape(
        jbuild(jreduced(JC.get("qwen3-1.7b")).hashed_variant(0.125)).init,
        jax.random.PRNGKey(0)))
    assert tm.init_shapes() == jshapes
    assert torch.equal(a["layers"]["ffn"]["out"]["w"],
                       b["layers"]["ffn"]["out"]["w"])


def test_bf16_lm_head_logits_are_never_rounded_to_bf16():
    """The tied head of a bf16 model returns fp32 logits of the bf16
    operands, as the JAX head does with ``preferred_element_type=float32``:
    within 1e-5 of the largest |logit| (sum order only; a bf16 rounding
    of the logits would be ~4e-3)."""
    jc = jreduced(JC.get("qwen3-1.7b"))
    tc = TC.reduced(TC.get("qwen3-1.7b"))
    assert jc.dtype == tc.dtype == "bfloat16"
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(4))
    tm = tbuild(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 8, tc.d_model)) \
        .astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    jl = np.asarray(jm.logits_head(jp, jx))
    tl = tm.logits_head(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert tl.dtype == torch.float32 and jl.dtype == np.float32
    err = np.abs(tl.numpy() - jl).max() / np.abs(jl).max()
    assert err <= 1e-5, err
