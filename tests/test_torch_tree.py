"""PyTorch port vs the JAX package: the tree helpers and checkpoint keys.

- ``optimizer.tree_leaves`` / ``tree_map`` / ``tree_unflatten`` and
  ``checkpoint._flatten`` / ``_unflatten`` against
  ``jax.tree_util.tree_flatten_with_path`` on trees that hold ``None``,
  lists, tuples and nested dicts: the same leaves in the same order, the
  same ``keystr`` keys, ``None`` put back where it stood;
- a checkpoint of such a tree round-trips, and the reference's
  ``repro.train.checkpoint`` writes the same keys for it;
- an existing train state keeps its keys and leaf count (the reduced
  element config's AdamW state with a compression residual);
- ``restore(prefix="['params']")`` loads the params of a whole train
  state into a params tree by key, from either package's checkpoint,
  and raises on a missing or an unexpected key.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.models import build as jbuild
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt

import repro_torch.configs as TC
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.models import build as tbuild
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _tree(kind: str):
    """A numpy tree of one of the shapes the helpers must walk."""
    a = lambda *s: np.arange(np.prod(s), dtype=np.float32).reshape(s)  # noqa: E731
    return {
        "none_leaf": {"b": a(2), "a": None, "c": a(3, 1)},
        "list": {"layers": [a(2), {"w": a(1), "skip": None}, a(4)]},
        "tuple": {"pair": (a(2), a(3)), "z": a(1)},
        "nested": {"opt": {"mu": [None, (a(2), None)], "nu": a(2)},
                   "params": {"x": a(5), "y": [a(1), a(2)]}, "step": None},
        "top_list": [a(1), None, {"q": a(2)}, (a(3),)],
    }[kind]


KINDS = ("none_leaf", "list", "tuple", "nested", "top_list")


def _jax_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(p) for p in path) for path, _ in flat], \
        [leaf for _, leaf in flat]


@pytest.mark.parametrize("kind", KINDS)
def test_flatten_matches_jax_tree_util(kind):
    tree = _tree(kind)
    keys, leaves = _jax_flat(tree)
    kv = tckpt._flatten(tree)
    assert [k for k, _ in kv] == keys
    assert all(a is b for (_, a), b in zip(kv, leaves))
    assert len(topt.tree_leaves(tree)) == len(leaves)
    assert all(a is b for a, b in zip(topt.tree_leaves(tree), leaves))


@pytest.mark.parametrize("kind", KINDS)
def test_unflatten_and_tree_map_put_none_back(kind):
    tree = _tree(kind)
    want = jax.tree_util.tree_map(lambda x: x * 2, tree)
    got = topt.tree_map(lambda x: x * 2, tree)
    assert jax.tree_util.tree_structure(got) \
        == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    leaves = [x + 1 for x in topt.tree_leaves(tree)]
    for back in (topt.tree_unflatten(tree, leaves),
                 tckpt._unflatten(tree, leaves)):
        assert jax.tree_util.tree_structure(back) \
            == jax.tree_util.tree_structure(tree)
        for a, b in zip(jax.tree_util.tree_leaves(back), leaves):
            assert a is b


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_keys_equal_the_reference(kind, tmp_path):
    tree = _tree(kind)
    ttree = topt.tree_map(torch.from_numpy, tree)
    tckpt.save(ttree, str(tmp_path / "t"), 1)
    jckpt.save(tree, str(tmp_path / "j"), 1)

    def keys(d):
        with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
            return [(m["key"], m["shape"]) for m in json.load(f)["leaves"]]
    assert keys(tmp_path / "t") == keys(tmp_path / "j")
    back = tckpt.restore(str(tmp_path / "j"),
                         topt.tree_map(torch.zeros_like, ttree))
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(ttree)
    for a, b in zip(topt.tree_leaves(back), topt.tree_leaves(ttree)):
        assert torch.equal(a, b)


def test_optimizer_unzip_keeps_tuples_as_leaves():
    params = {"w": torch.ones(2), "b": torch.zeros(3)}
    opt = topt.adamw(topt.constant_lr(1e-2))
    state = opt.init(params)
    grads = topt.tree_map(torch.ones_like, params)
    new, st = opt.update(grads, state, params, torch.tensor(0))
    assert set(new) == {"b", "w"} and set(st) == {"m", "v"}
    assert new["w"].shape == (2,) and st["v"]["b"].shape == (3,)


def _tcfg():
    return TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32") \
        .hashed_variant(0.125)


@pytest.fixture(scope="module")
def pair():
    jc = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32") \
        .hashed_variant(0.125)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = tbuild(_tcfg(), device="cpu")
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp),
                                         _tcfg(), device="cpu")


def test_train_state_keys_and_leaf_count_unchanged():
    """The reduced element config's AdamW state with a residual: 53
    leaves, none of them None or a sequence, so the repair changes no
    key of an existing checkpoint."""
    tm = tbuild(_tcfg(), device="cpu")
    opt = topt.adamw(topt.constant_lr(1e-3))
    state = tstep.init_state(tm, opt, seed=0, with_residual=True)
    kv = tckpt._flatten(state)
    assert len(kv) == 53
    assert kv[0][0].startswith("['opt']/['m']/") and kv[-1][0] == "['step']"
    keys, _ = _jax_flat(topt.tree_map(lambda t: t.numpy(), state))
    assert [k for k, _ in kv] == keys


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_prefix_restore_loads_params_of_a_train_state(writer, pair,
                                                      tmp_path):
    jm, jp, tm, tp = pair
    d = str(tmp_path / "ck")
    if writer == "port":
        opt = topt.adamw(topt.constant_lr(1e-3))
        tckpt.save({"params": tp, "opt": opt.init(tp),
                    "step": torch.tensor(3, dtype=torch.int32)}, d, 3)
    else:
        jo = jopt.adamw(jopt.constant_lr(1e-3))
        jckpt.save({"params": jp, "opt": jo.init(jp),
                    "step": jnp.asarray(3, jnp.int32)}, d, 3)
    got = tckpt.restore(d, tm.empty_params(), prefix="['params']")
    for (ka, a), (kb, b) in zip(tckpt._flatten(params_to_numpy(got)),
                                tckpt._flatten(params_to_numpy(tp))):
        assert ka == kb and np.array_equal(a, b)
    # the whole-state target the reference's launcher uses cannot load it
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.restore(d, {"params": tm.empty_params(), "opt": None,
                          "step": torch.zeros((), dtype=torch.int32)})


def test_prefix_restore_raises_on_missing_or_unexpected_keys(tmp_path):
    d = str(tmp_path / "ck")
    tckpt.save({"params": {"a": torch.ones(2), "b": torch.ones(3)},
                "step": torch.tensor(1)}, d, 1)
    with pytest.raises(ValueError, match="missing"):
        tckpt.restore(d, {"a": torch.zeros(2), "c": torch.zeros(3)},
                      prefix="['params']")
    with pytest.raises(ValueError, match="unexpected"):
        tckpt.restore(d, {"a": torch.zeros(2)}, prefix="['params']")
    got = tckpt.restore(d, {"a": torch.zeros(2), "b": torch.zeros(3)},
                        prefix="['params']")
    assert torch.equal(got["b"], torch.ones(3))
