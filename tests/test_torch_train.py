"""PyTorch port vs the JAX package: training.

The reduced qwen3-1.7b config (2 layers, d 64) in fp32, dense,
element-hashed and block-hashed, with params carried across as numpy.
The JAX side runs its scan path (the reduced configs' default; its
Pallas path refuses reduced widths), the port its kernel path, which on
the CPU runs the kernels' plain versions through the autograd Function.

- ``train_loss`` and every gradient against ``jax.value_and_grad``;
- three AdamW train steps against the JAX ``make_train_step`` (losses,
  and params through ``params_to_numpy``);
- the chunked attention of long sequences against the JAX ``attend``;
- ``microbatches=2`` against 1;
- the optimizer formulas, the schedules and clipping;
- the ``lm_stream`` batches bitwise;
- ``launch.train --device cpu --reduced`` end to end.

Tolerances (fp32; the two packages sum in another order): loss within
1e-5 relative; each gradient and param leaf within 1e-5 x max(1, largest
reference value) for one evaluation, 1e-4 after three optimizer steps
(AdamW divides by sqrt(v), which magnifies tiny gradient differences
where v is small); optimizer formulas 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.data import lm_stream as jlm
from repro.models import build as jbuild
from repro.train import optimizer as jopt
from repro.train import step as jstep

import repro_torch.configs as TC
from repro_torch.data import lm_stream as tlm
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build as tbuild
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(kind):
    jc = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32")
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32")
    if kind == "element":
        jc, tc = jc.hashed_variant(0.125), tc.hashed_variant(0.125)
    elif kind == "block":
        # (32, 32) tiles divide every reduced shape (64, 32, 128)
        jc = jc.hashed_variant(0.125, mode="block").with_(hash_block=(32, 32))
        tc = tc.hashed_variant(0.125, mode="block").with_(hash_block=(32, 32))
    return jc, tc


def _pair(kind, seed=1):
    jc, tc = _cfgs(kind)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, b=2, s=16, step=0):
    it = jlm.batches(seed=17, batch=b, seq_len=s, vocab=cfg.vocab_size,
                     start_step=step)
    return next(it)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close_tree(got, want, tol):
    want = dict(_paths(want))
    got = dict(_paths(got))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[path], np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=".".join(path))


@pytest.mark.parametrize("kind", ["dense", "element", "block"])
def test_train_loss_and_grads_match_reference(kind):
    jm, jp, tm, tp = _pair(kind)
    assert tm.cfg.hash_path == "pallas" and jm.cfg.hash_path == "scan"
    batch = _batch(jm.cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.train_loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {p: t.clone().requires_grad_(True) for p, t in _paths(tp)}

    def tree(node, prefix=()):
        if isinstance(node, dict):
            return {k: tree(v, prefix + (k,)) for k, v in node.items()}
        return leaves[prefix]
    tloss, tmet = tm.train_loss(tree(tp), {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    assert float(tmet["accuracy"]) == pytest.approx(float(jmet["accuracy"]))
    assert int(tmet["tokens"]) == int(jmet["tokens"])
    tgrads = {}
    for path, t in leaves.items():
        node = tgrads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.grad.numpy()
    _close_tree(tgrads, jax.tree.map(np.asarray, jgrads), 1e-5)


def test_three_adamw_steps_match_reference():
    jm, jp, tm, tp = _pair("element", seed=2)
    jo = jopt.adamw(jopt.warmup_cosine_lr(1e-2, 2, 10))
    to = topt.adamw(topt.warmup_cosine_lr(1e-2, 2, 10))
    jtrain = jax.jit(jstep.make_train_step(jm, jo, clip_norm=1.0))
    ttrain = tstep.make_train_step(tm, to, clip_norm=1.0)
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": to.init(tp),
              "step": torch.zeros((), dtype=torch.int32)}
    for step in range(3):
        batch = _batch(jm.cfg, step=step)
        jstate, jmet = jtrain(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tstate, tmet = ttrain(tstate, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert int(tstate["step"]) == 3
    _close_tree(params_to_numpy(tstate["params"]),
                jax.tree.map(np.asarray, jstate["params"]), 1e-4)


def test_chunked_attention_matches_reference():
    """Past 2048 positions both packages run the queries in chunks of 512;
    S = 2100 leaves a ragged last chunk.  fp32, tiny heads."""
    from repro.nn import attention as JATT
    from repro_torch.nn import attention as TATT
    kw = dict(d_model=16, num_heads=2, num_kv_heads=1, head_dim=8)
    jplan = JATT.AttentionPlan(**kw, dtype=jnp.float32)
    tplan = TATT.AttentionPlan(**kw, dtype=torch.float32)
    rng = np.random.default_rng(9)
    s = 2100
    q, k, v = (rng.standard_normal((1, s, h, 8)).astype(np.float32)
               for h in (2, 1, 1))
    pos = np.arange(s, dtype=np.int32)
    want = JATT.attend(jplan, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       jnp.asarray(pos), jnp.asarray(pos),
                       jnp.ones((s,), bool))
    got = TATT.attend(tplan, torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v), torch.from_numpy(pos).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_two_microbatches_match_one():
    """Plain SGD at lr 1, so the params after one step carry the averaged
    gradient itself (AdamW would divide it by its own magnitude)."""
    _, _, tm, tp = _pair("element", seed=3)
    opt = topt.sgd_momentum(topt.constant_lr(1.0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg, b=4).items()}
    outs = []
    for mb in (1, 2):
        train = tstep.make_train_step(tm, opt, num_microbatches=mb,
                                      accum_dtype=torch.float32)
        state = {"params": tp, "opt": opt.init(tp),
                 "step": torch.zeros((), dtype=torch.int32)}
        outs.append(train(state, batch))
    (s1, m1), (s2, m2) = outs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    _close_tree(params_to_numpy(s2["params"]),
                params_to_numpy(s1["params"]), 1e-5)


def test_optimizer_formulas_and_schedules_match_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": 3 * rng.standard_normal(5).astype(np.float32)}}
             for _ in range(3)]
    jt = lambda t: jax.tree.map(jnp.asarray, t)            # noqa: E731
    tt = lambda t: topt.tree_map(torch.from_numpy, t)      # noqa: E731
    for name, kw in (("adamw", {}), ("sgd_momentum", {"weight_decay": 0.01})):
        jo = jopt.make(name, jopt.warmup_cosine_lr(0.1, 2, 6), **kw)
        to = topt.make(name, topt.warmup_cosine_lr(0.1, 2, 6), **kw)
        jp, tp = jt(params), tt(params)
        js, ts = jo.init(jp), to.init(tp)
        for step, g in enumerate(grads):
            jg, jn = jopt.clip_by_global_norm(jt(g), 1.0)
            tg, tn = topt.clip_by_global_norm(tt(g), 1.0)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
            jp, js = jo.update(jg, js, jp, jnp.asarray(step, jnp.int32))
            tp, ts = to.update(tg, ts, tp, torch.tensor(step,
                                                        dtype=torch.int32))
        _close_tree(params_to_numpy(tp), jax.tree.map(np.asarray, jp), 1e-6)
        _close_tree(params_to_numpy(ts), jax.tree.map(np.asarray, js), 1e-6)
    jl = jopt.warmup_cosine_lr(3e-4, 10, 100)
    tl = topt.warmup_cosine_lr(3e-4, 10, 100)
    for step in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(
            float(tl(torch.tensor(step, dtype=torch.int32))),
            float(jl(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    assert float(topt.constant_lr(0.5)(torch.tensor(3))) == 0.5


def test_lm_stream_batches_bitwise_equal_to_reference():
    kw = dict(seed=17, batch=3, seq_len=24, vocab=512)
    jit_, tit = jlm.batches(**kw, start_step=5), tlm.batches(**kw,
                                                             start_step=5)
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        assert set(jb) == set(tb) == {"tokens", "targets"}
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


def test_params_to_numpy_round_trips_bf16_bitwise():
    _, tc = _cfgs("element")
    tm = tbuild(tc.with_(dtype="bfloat16"), device="cpu")
    params = tm.init(0)
    back = params_from_numpy(params_to_numpy(params), tm.cfg, device="cpu")
    for (path, a), (_, b) in zip(_paths(params), _paths(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    arr = params_to_numpy(params)["layers"]["attn"]["q"]["w"]
    assert arr.dtype.name == "bfloat16"


def test_launch_train_cpu_reduced_end_to_end(capsys):
    from repro_torch.launch import train
    assert train.main(["--arch", "qwen3-1.7b", "--reduced", "--hashed",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0 loss ")
    assert out[-2] == '{"final_step": 2, "straggler_count": 0}'
    assert out[-1].startswith("loss: first=")


def test_grad_compression_is_not_ported_yet():
    """Gradient compression is ported now (``test_torch_train_infra.py``
    holds it against the reference); the test keeps its name and checks
    what is left of the old refusal: an unknown compressor is refused,
    and the known ones build a step."""
    _, _, tm, _ = _pair("dense")
    opt = topt.adamw(topt.constant_lr(1e-3))
    with pytest.raises(ValueError):
        tstep.make_train_step(tm, opt, grad_compressor="fp4")
    for kind in ("int8", "hashed_space"):
        assert callable(tstep.make_train_step(tm, opt, grad_compressor=kind))
