"""PyTorch port vs the JAX package: the paper's §6 MLP experiments.

- ``data.mnist_synthetic.load``: every dataset, train and test, bytewise;
- the bookkeeping of ``MLPSpec`` (budgets, free params, LRD ranks,
  hashed specs, equivalent dense dims) for both paper depths at
  compressions 1, 1/8 and 1/64: equal integers;
- the RER mask bitwise;
- each method's logits, ``xent``, ``distill_loss`` and every param
  gradient against ``jax.value_and_grad``, params (and the LRD fixed
  factor) carried across;
- six SGD-momentum steps of ``fit`` against the reference's ``_step`` on
  the same minibatches (dropout off), and one step on soft targets;
- ``evaluate`` and ``soft_targets`` on the same params;
- dropout's keep rate and scaling, in the port alone;
- the registry entries, ``run_method`` for every method and
  ``examples/paper_mnist_torch.py`` end to end, on the CPU.

The JAX side runs ``path="materialize"`` (its own choice), the port its
kernel path, which on the CPU runs the kernels' plain versions.
Tolerances (fp32; the packages sum in another order): logits, losses and
gradients within 1e-5 x max(1, largest reference value); params after
six steps within 1e-4 x max(1, largest reference value).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.data import mnist_synthetic as jdata
from repro.paper import mlp as jmlp
from repro.paper import train as jtrain

import repro_torch.configs as TC
from repro_torch.data import mnist_synthetic as tdata
from repro_torch.interop import mlp_params_from_numpy, mlp_params_to_numpy
from repro_torch.paper import mlp as tmlp
from repro_torch.paper import train as ttrain

ROOT = Path(__file__).resolve().parents[1]
SMALL = {3: (784, 32, 10), 5: (784, 32, 32, 32, 10)}
PAPER = {3: (784, 1000, 10), 5: (784, 1000, 1000, 1000, 10)}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _specs(dims, method, compression, **kw):
    kw = dict(dict(dropout=0.0, input_dropout=0.0, seed=3), **kw)
    return (jmlp.MLPSpec(tuple(dims), method=method, compression=compression,
                         **kw),
            tmlp.MLPSpec(tuple(dims), method=method, compression=compression,
                         **kw))


def _carry(jspec, tspec, seed=0):
    """Reference params (and LRD factors) and the port's copies."""
    jp = jmlp.init(jspec, jax.random.PRNGKey(seed))
    fixed = [np.asarray(jmlp._lrd_fixed(jspec, l))
             if jspec.method == "lrd" else None
             for l in range(jspec.n_layers)]
    tp, tfixed = mlp_params_from_numpy(jax.tree.map(np.asarray, jp), tspec,
                                       device="cpu", lrd_fixed=fixed)
    return jp, tp, tfixed


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _data(n, seed=0, classes=10):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784), dtype=np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    soft = rng.random((n, classes)).astype(np.float32)
    return x, y, soft / soft.sum(-1, keepdims=True)


# ---------------------------------------------------------------------------
# data and bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", jdata.DATASETS)
def test_mnist_synthetic_bytewise(dataset):
    assert tdata.DATASETS == jdata.DATASETS
    assert tdata.PAPER_SIZES == jdata.PAPER_SIZES
    assert tdata.num_classes(dataset) == jdata.num_classes(dataset)
    for split, seed in (("train", 0), ("test", 1)):
        jx, jy = jdata.load(dataset, split, n=64, seed=seed)
        tx, ty = tdata.load(dataset, split, n=64, seed=seed)
        assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
        assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("compression", [1.0, 1 / 8, 1 / 64])
def test_bookkeeping_integers_equal(depth, compression):
    dims = PAPER[depth]
    assert tmlp.equivalent_dense_dims(dims, compression) \
        == jmlp.equivalent_dense_dims(dims, compression)
    for method in ("dense", "hashed", "rer", "lrd"):
        js, ts = _specs(dims, method, compression, seed=0)
        assert ts.free_params() == js.free_params(), method
        for l in range(js.n_layers):
            assert ts.layer_budget(l) == js.layer_budget(l)
            assert ts.lrd_rank(l) == js.lrd_rank(l)
            assert ts.lrd_learn_left(l) == js.lrd_learn_left(l)
            assert ts.hashed_spec(l).to_dict() == js.hashed_spec(l).to_dict()
            assert ts.hashed_spec(l).num_buckets \
                == js.hashed_spec(l).num_buckets


@pytest.mark.parametrize("dims,compression", [((784, 1000, 10), 1 / 64),
                                              ((784, 32, 10), 1 / 8)])
def test_rer_mask_bitwise(dims, compression):
    js, ts = _specs(dims, "rer", compression)
    for l in range(js.n_layers):
        want = np.asarray(jmlp._rer_mask(js, l))
        got = tmlp.rer_mask(ts, l, "cpu").numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_registry_lists_the_paper_mlps():
    for name in ("hashmlp-3layer", "hashmlp-5layer"):
        assert name in TC.names()
        t, j = TC.get(name), JC.get(name)
        for field in ("family", "arch_kind", "num_layers", "d_model",
                      "d_ff", "vocab_size", "activation"):
            assert getattr(t, field) == getattr(j, field), (name, field)


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("method", ["dense", "hashed", "rer", "lrd"])
def test_logits_losses_and_grads_match_reference(depth, method):
    js, ts = _specs(SMALL[depth], method, 1 / 8)
    jp, tp, tfixed = _carry(js, ts)
    x, y, soft = _data(24, seed=depth)

    jlogits = jmlp.apply(js, jp, jnp.asarray(x), train=False)
    tlogits = tmlp.apply(ts, tp, torch.from_numpy(x), train=False,
                         fixed=tfixed)
    _close(tlogits.numpy(), jlogits, 1e-5, "logits")

    def jloss(p, use_soft):
        logits = jmlp.apply(js, p, jnp.asarray(x), train=False)
        if use_soft:
            return jmlp.distill_loss(logits, jnp.asarray(y),
                                     jnp.asarray(soft), 0.7, 2.0)
        return jmlp.xent(logits, jnp.asarray(y))

    for use_soft in (False, True):
        jl, jg = jax.value_and_grad(jloss)(jp, use_soft)
        leaves = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
                  for p in tp]
        logits = tmlp.apply(ts, leaves, torch.from_numpy(x), fixed=tfixed)
        if use_soft:
            tl = tmlp.distill_loss(logits, torch.from_numpy(y),
                                   torch.from_numpy(soft), 0.7, 2.0)
        else:
            tl = tmlp.xent(logits, torch.from_numpy(y))
        tl.backward()
        _close(float(tl.detach()), float(jl), 1e-5, f"loss soft={use_soft}")
        for l, (jgl, tpl) in enumerate(zip(jg, leaves)):
            assert set(jgl) == set(tpl)
            for k in jgl:
                _close(tpl[k].grad.numpy(), jgl[k], 1e-5,
                       f"grad {l}.{k} soft={use_soft}")


def test_params_cross_both_ways_with_shapes_checked():
    js, ts = _specs(SMALL[3], "lrd", 1 / 8)
    jp, tp, tfixed = _carry(js, ts)
    back = mlp_params_to_numpy(tp)
    for a, b in zip(back, jax.tree.map(np.asarray, jp)):
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k])
    own = tmlp.fixed_factors(ts, "cpu")
    assert all(f.shape == o.shape for f, o in zip(tfixed, own))
    bad = jax.tree.map(np.asarray, jp)
    bad[0]["u"] = bad[0]["u"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        mlp_params_from_numpy(bad, ts, device="cpu")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["hashed", "lrd"])
def test_six_sgd_momentum_steps_match_reference(method):
    """``fit`` over 2 epochs of 3 minibatches against the reference's
    ``_step`` on the same minibatch order and cosine learning rates."""
    js, ts = _specs(SMALL[3], method, 1 / 8)
    jp, tp, tfixed = _carry(js, ts, seed=1)
    x, y, _ = _data(150, seed=5)
    cfg = ttrain.TrainConfig(epochs=2, batch=50, lr=0.05)
    tparams, hist = ttrain.fit(ts, x, y, cfg=cfg, seed=4, params=tp,
                               fixed=tfixed, device="cpu")

    rng = np.random.default_rng(4)
    mu = jax.tree.map(jnp.zeros_like, jp)
    soft = jnp.zeros((50, 10), jnp.float32)
    step, losses = 0, []
    for _ in range(2):
        perm = rng.permutation(150)
        for i in range(3):
            idx = perm[i * 50:(i + 1) * 50]
            jp, mu, loss = jtrain._step(
                js, False, jp, mu, jnp.asarray(x[idx]), jnp.asarray(y[idx]),
                soft, jax.random.PRNGKey(step),
                jnp.float32(jtrain._lr_at(cfg, step, 6)),
                jnp.float32(0.5), jnp.float32(4.0), jnp.float32(0.9))
            step += 1
        losses.append(float(loss))
    assert ttrain._lr_at(cfg, 3, 6) == jtrain._lr_at(cfg, 3, 6)
    np.testing.assert_allclose(hist["loss"], losses, rtol=1e-5)
    for l, (a, b) in enumerate(zip(mlp_params_to_numpy(tparams), jp)):
        for k in b:
            _close(a[k], b[k], 1e-4, f"param {l}.{k}")


def test_soft_target_step_matches_reference():
    js, ts = _specs(SMALL[3], "hashed", 1 / 8)
    jp, tp, _ = _carry(js, ts, seed=2)
    x, y, soft = _data(50, seed=6)
    mu = jax.tree.map(jnp.zeros_like, jp)
    jp2, jmu, jl = jtrain._step(
        js, True, jp, mu, jnp.asarray(x), jnp.asarray(y), jnp.asarray(soft),
        jax.random.PRNGKey(0), jnp.float32(0.05), jnp.float32(0.7),
        jnp.float32(2.0), jnp.float32(0.9))
    tmu = [{k: torch.zeros_like(v) for k, v in p.items()} for p in tp]
    tp2, tmu2, tl = ttrain._step(
        ts, True, tp, tmu, torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(soft), None, 0.05, 0.7, 2.0, 0.9)
    _close(float(tl), float(jl), 1e-5, "loss")
    for a, b, c, d in zip(tp2, jp2, tmu2, jmu):
        for k in b:
            _close(a[k].numpy(), b[k], 1e-5, k)
            _close(c[k].numpy(), d[k], 1e-5, k)


def test_evaluate_and_soft_targets_match_reference():
    js, ts = _specs(SMALL[3], "rer", 1 / 8)
    jp, tp, tfixed = _carry(js, ts, seed=3)
    x, y, _ = _data(300, seed=7)
    assert ttrain.evaluate(ts, tp, x, y, batch=128, fixed=tfixed) \
        == jtrain.evaluate(js, jp, x, y, batch=128)
    _close(ttrain.soft_targets(ts, tp, x, 2.0, batch=128, fixed=tfixed),
           jtrain.soft_targets(js, jp, x, 2.0, batch=128), 1e-5)


def test_dropout_keep_rate_and_scaling():
    """Port alone (the reference draws its masks from jax.random)."""
    g = torch.Generator().manual_seed(0)
    x = torch.ones(400, 1000)
    out = tmlp._dropout(x, 0.3, g)
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.005
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / 0.7))
    _, ts = _specs(SMALL[5], "hashed", 1 / 8, dropout=0.3, input_dropout=0.1)
    params = tmlp.init(ts, torch.Generator().manual_seed(0), "cpu")
    xb = torch.from_numpy(_data(8)[0])
    plain = tmlp.apply(ts, params, xb)
    assert torch.equal(plain, tmlp.apply(ts, params, xb, train=True))
    a = tmlp.apply(ts, params, xb, generator=torch.Generator()
                   .manual_seed(1), train=True)
    b = tmlp.apply(ts, params, xb, generator=torch.Generator()
                   .manual_seed(1), train=True)
    assert torch.equal(a, b) and not torch.equal(a, plain)


@pytest.mark.parametrize("method", ["hashed", "hashed_dk", "nn", "dk", "rer",
                                    "lrd"])
def test_run_method_on_cpu(method):
    x, y = tdata.load("basic", "train", n=100, seed=0)
    xt, yt = tdata.load("basic", "test", n=60, seed=1)
    dims = (784, 16, 10)
    tspec = tmlp.MLPSpec(dims)
    teacher = (tspec, tmlp.init(tspec, torch.Generator().manual_seed(0),
                                "cpu"))
    r = ttrain.run_method(method, dims, 1 / 8, x, y, xt, yt,
                          ttrain.TrainConfig(epochs=2), teacher=teacher,
                          device="cpu")
    base = {"nn": "dense", "dk": "dense", "hashed_dk": "hashed"}
    jspec = jmlp.MLPSpec(
        jmlp.equivalent_dense_dims(dims, 1 / 8) if method in ("nn", "dk")
        else dims, method=base.get(method, method),
        compression=1.0 if method in ("nn", "dk") else 1 / 8)
    assert r["free_params"] == jspec.free_params()
    assert 0.0 <= r["test_err"] <= 1.0
    assert len(r["history"]["loss"]) == 2
    assert np.isfinite(r["history"]["mean_loss"]).all()


def test_paper_mnist_torch_example_runs_on_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "paper_mnist_torch.py"),
         "--device", "cpu", "--hidden", "16", "--epochs", "1", "--n", "200"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [line.split()[0] for line in out.stdout.splitlines()
            if line.endswith("%") and not line.startswith("teacher")]
    assert rows == ["hashed", "hashed_dk", "nn", "dk", "rer", "lrd"]
