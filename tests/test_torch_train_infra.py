"""PyTorch port vs the JAX package: gradient compression, checkpoints,
fault tolerance and the launcher's resume, preemption and compression.

- the sketch's bucket indices and signs bitwise; ``int8_roundtrip``,
  ``sketch_roundtrip`` and ``make_compressor`` over a tree that mixes
  leaves below and above ``min_size`` (each leaf's seed checked) within
  1e-6; ``wire_bytes`` as equal integers;
- three AdamW steps of the reduced fp32 element config with each
  compressor against the reference's
  ``make_train_step(grad_compressor=...)``, as ``test_torch_train.py``
  runs its three steps and with its tolerances.  The vocabulary is
  widened to 2048 on both sides, so that the embedding (131072 values)
  reaches ``min_size`` and is compressed: at the reduced width every
  leaf is smaller and would pass through;
- checkpoints: the port's save and restore bitwise in fp32 and bf16,
  commit markers, keep-k GC, ``latest_step``; a checkpoint written by
  the reference restores into the port and the reverse, with equal keys,
  shapes and values; a bf16 leaf written byte for byte as the reference
  writes it;
- ``Heartbeat``, ``watchdog``, ``StepTimer``'s straggler flag and
  ``run_with_restarts``;
- ``launch.train.run(device="cpu")``: 4 steps with a checkpoint every 2,
  then 6 steps resumed at step 4, against an uninterrupted 6-step run;
  ``--grad-compress`` end to end;
- SIGTERM, only ever sent to a child process running the launcher: it
  must exit 0 with an emergency checkpoint committed.  No test here
  signals the pytest process, starts a timer or installs a handler in it.
"""
import json
import os
import select
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.configs.reduced import reduced as jreduced
from repro.data import lm_stream as jlm
from repro.models import build as jbuild
from repro.train import checkpoint as jckpt
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import step as jstep

import repro_torch.configs as TC
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import fault_tolerance as tft
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _close_tree(got, want, tol):
    want, got = dict(_paths(want)), dict(_paths(got))
    assert set(got) == set(want)
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(np.asarray(got[path], np.float32), w,
                                   rtol=0, atol=tol * scale,
                                   err_msg=".".join(path))


def _grad_tree(seed=0):
    """Leaves of 50, 300 and 1000 values (min_size 100 in the tests),
    keys inserted out of sorted order."""
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal((10, 100)).astype(np.float32),
            "a": {"y": rng.standard_normal(50).astype(np.float32),
                  "b": rng.standard_normal((20, 15)).astype(np.float32)}}


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _to_np(tree):
    return {k: _to_np(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,seed", [(5000, 625, 0xFEED ^ 3), (777, 1, 0),
                                      (4096, 4096, 12345)])
def test_sketch_indices_and_signs_bitwise(n, k, seed):
    jidx, jsgn = jgc._idx_sgn(jgc.SketchSpec(n=n, k=k, seed=seed))
    idx, sgn, counts = tgc.sketch_tables(tgc.SketchSpec(n=n, k=k, seed=seed),
                                         "cpu")
    assert idx.dtype == torch.int32 and sgn.dtype == torch.int8
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(sgn.numpy().astype(np.float32), np.asarray(jsgn))
    assert np.array_equal(counts.numpy(),
                          np.bincount(np.asarray(jidx), minlength=k))


def test_sketch_tables_hash_in_chunks(monkeypatch):
    """The chunked hashing gives the same tables as one pass."""
    spec = tgc.SketchSpec(n=10_000, k=999, seed=7)
    whole = tgc.sketch_tables(spec, "cpu")
    monkeypatch.setattr(tgc, "_CHUNK", 1024)
    monkeypatch.setattr(tgc, "_SKETCH", {})
    for a, b in zip(tgc.sketch_tables(spec, "cpu"), whole):
        assert torch.equal(a, b)


def test_int8_and_sketch_roundtrips_match_reference():
    rng = np.random.default_rng(1)
    g = rng.standard_normal((64, 40)).astype(np.float32)
    r = (0.1 * rng.standard_normal((64, 40))).astype(np.float32)
    jq, js = jgc.int8_compress(jnp.asarray(g))
    tq, ts = tgc.int8_compress(torch.from_numpy(g))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
    for jfn, tfn in ((jgc.int8_roundtrip, tgc.int8_roundtrip),
                     (lambda a, b: jgc.sketch_roundtrip(a, b, 0.125, 99),
                      lambda a, b: tgc.sketch_roundtrip(a, b, 0.125, 99))):
        ja, jr = jfn(jnp.asarray(g), jnp.asarray(r))
        ta, tr = tfn(torch.from_numpy(g), torch.from_numpy(r))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)
    spec = tgc.SketchSpec(n=g.size, k=300, seed=5)
    G = tgc.sketch_compress(torch.from_numpy(g).reshape(-1), spec)
    jG = jgc.sketch_compress(jnp.asarray(g).ravel(),
                             jgc.SketchSpec(n=g.size, k=300, seed=5))
    np.testing.assert_allclose(G.numpy(), np.asarray(jG), atol=1e-6)
    for norm in (False, True):
        np.testing.assert_allclose(
            tgc.sketch_decompress(G, spec, g.shape, normalize=norm).numpy(),
            np.asarray(jgc.sketch_decompress(
                jG, jgc.SketchSpec(n=g.size, k=300, seed=5), g.shape,
                normalize=norm)), atol=1e-6)


@pytest.mark.parametrize("kind", ["none", "int8", "hashed_space"])
def test_make_compressor_tree_matches_reference(kind):
    grads, res = _grad_tree(0), _grad_tree(1)
    jg, jr = jgc.make_compressor(kind, 0.125, min_size=100)(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, res))
    tg, tr = tgc.make_compressor(kind, 0.125, min_size=100)(
        _to_torch(grads), _to_torch(res))
    _close_tree(_to_np(tg), jax.tree.map(np.asarray, jg), 1e-6)
    _close_tree(_to_np(tr), jax.tree.map(np.asarray, jr), 1e-6)
    # sorted-key order: a.b (li 0, 300 values), a.y (li 1, 50, passes
    # through), z (li 2, 1000)
    assert torch.equal(tg["a"]["y"], torch.from_numpy(grads["a"]["y"]))
    if kind == "hashed_space":
        for li, path in ((0, ("a", "b")), (2, ("z",))):
            g, r = grads, res
            for key in path:
                g, r = g[key], r[key]
            want, _ = tgc.sketch_roundtrip(torch.from_numpy(g),
                                           torch.from_numpy(r), 0.125,
                                           seed=0xFEED ^ li)
            got = tg
            for key in path:
                got = got[key]
            assert torch.equal(got, want), path


@pytest.mark.parametrize("kind", ["none", "int8", "hashed_space"])
def test_wire_bytes_equal(kind):
    grads = _grad_tree(0)
    grads["h"] = np.zeros((300,), np.float16)
    jb = jgc.wire_bytes(jax.tree.map(jnp.asarray, grads), kind, 0.125,
                        min_size=100)
    tb = tgc.wire_bytes(_to_torch(grads), kind, 0.125, min_size=100)
    assert isinstance(tb, int) and tb == jb


def _pair(vocab, seed=2):
    jc = jreduced(JC.get("qwen3-1.7b")).with_(dtype="float32") \
        .hashed_variant(0.125).with_(vocab_size=vocab)
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(dtype="float32") \
        .hashed_variant(0.125).with_(vocab_size=vocab)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = tbuild(tc, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jm, jp, tm, tp


def _batch(cfg, step):
    return next(jlm.batches(seed=17, batch=2, seq_len=16,
                            vocab=cfg.vocab_size, start_step=step))


@pytest.mark.parametrize("kind", ["hashed_space", "int8"])
def test_three_adamw_steps_with_compression_match_reference(kind):
    jm, jp, tm, tp = _pair(vocab=2048)
    assert jm.cfg.padded_vocab * jm.cfg.d_model >= 65536
    jo = jopt.adamw(jopt.warmup_cosine_lr(1e-2, 2, 10))
    to = topt.adamw(topt.warmup_cosine_lr(1e-2, 2, 10))
    jtrain = jax.jit(jstep.make_train_step(jm, jo, clip_norm=1.0,
                                           grad_compressor=kind))
    ttrain = tstep.make_train_step(tm, to, clip_norm=1.0,
                                   grad_compressor=kind)
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.zeros((), jnp.int32),
              "residual": jax.tree.map(
                  lambda p: jnp.zeros(p.shape, jnp.float32), jp)}
    tstate = {"params": tp, "opt": to.init(tp),
              "step": torch.zeros((), dtype=torch.int32),
              "residual": tgc.init_residual(tp)}
    for step in range(3):
        batch = _batch(jm.cfg, step)
        jstate, jmet = jtrain(jstate, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        tstate, tmet = ttrain(tstate, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-5)
    assert int(tstate["step"]) == 3
    res = params_to_numpy(tstate["residual"])
    assert np.abs(res["embed"]["emb"]).max() > 0     # it was compressed
    _close_tree(params_to_numpy(tstate["params"]),
                jax.tree.map(np.asarray, jstate["params"]), 1e-4)
    _close_tree(res, jax.tree.map(np.asarray, jstate["residual"]), 1e-4)


def test_init_state_with_residual():
    tc = TC.reduced(TC.get("qwen3-1.7b")).hashed_variant(0.125)
    model = tbuild(tc, device="cpu")
    opt = topt.adamw(topt.constant_lr(1e-3))
    state = tstep.init_state(model, opt, seed=0, with_residual=True)
    assert sorted(state) == ["opt", "params", "residual", "step"]
    for (pa, p), (ra, r) in zip(_paths(state["params"]),
                                _paths(state["residual"])):
        assert pa == ra and r.shape == p.shape
        assert r.dtype == torch.float32 and not r.any()
    assert "residual" not in tstep.init_state(model, opt, seed=0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _mixed_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 3, generator=g)
                       .to(torch.bfloat16),
                       "b": {"c": torch.randn(5, generator=g)}},
            "opt": {"m": torch.randn(4, 3, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_save_restore_bitwise_fp32_and_bf16(tmp_path):
    state = _mixed_state()
    path = tckpt.save(state, str(tmp_path), 7)
    assert path.endswith("step_00000007")
    target = _mixed_state(seed=1)
    got = tckpt.restore(str(tmp_path), target)
    for (pa, a), (pb, b) in zip(_paths(got), _paths(state)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    with open(os.path.join(path, "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    assert [m["key"] for m in leaves] == [
        "['opt']/['m']", "['params']/['b']/['c']", "['params']/['w']",
        "['step']"]
    assert [m["dtype"] for m in leaves] == ["float32", "float32",
                                            "bfloat16", "int32"]


def test_bf16_leaf_written_as_the_reference_writes_it(tmp_path):
    bits = np.random.default_rng(0).integers(0, 2 ** 16, 12, dtype=np.uint16)
    import ml_dtypes
    jckpt.save({"w": jnp.asarray(bits.view(ml_dtypes.bfloat16))},
               str(tmp_path / "j"), 1)
    tckpt.save({"w": torch.from_numpy(bits.astype(np.int16))
                .view(torch.bfloat16)}, str(tmp_path / "t"), 1)
    leaf = "step_00000001/arr_00000.npy"
    assert (tmp_path / "t" / leaf).read_bytes() \
        == (tmp_path / "j" / leaf).read_bytes()
    got = tckpt.restore(str(tmp_path / "j"),
                        {"w": torch.zeros(12, dtype=torch.bfloat16)})
    assert np.array_equal(got["w"].view(torch.int16).numpy()
                          .view(np.uint16), bits)


def test_checkpoint_commit_markers_gc_and_latest(tmp_path):
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None and tckpt.available_steps(d) == []
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, _mixed_state())
    for s in (1, 2, 3, 4, 5):
        tckpt.save(_mixed_state(s), d, s, keep=2)
    assert tckpt.available_steps(d) == [4, 5]
    assert not os.path.exists(os.path.join(d, "step_00000003"))
    # a half-written step (no marker) and a .tmp are never seen
    os.makedirs(os.path.join(d, "step_00000009"))
    os.makedirs(os.path.join(d, "step_00000010.tmp"))
    assert tckpt.latest_step(d) == 5
    got = tckpt.restore(d, _mixed_state())
    assert torch.equal(got["opt"]["m"], _mixed_state(5)["opt"]["m"])
    got4 = tckpt.restore(d, _mixed_state(), step=4)
    assert torch.equal(got4["opt"]["m"], _mixed_state(4)["opt"]["m"])
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore(d, {"step": torch.zeros((), dtype=torch.int32)})


def test_checkpoints_cross_between_the_packages(tmp_path):
    jm, jp, tm, tp = _pair(vocab=512, seed=3)
    jo = jopt.adamw(jopt.constant_lr(1e-3))
    to = topt.adamw(topt.constant_lr(1e-3))
    jstate = {"params": jp, "opt": jo.init(jp),
              "step": jnp.asarray(4, jnp.int32)}
    tstate = {"params": tp, "opt": to.init(tp),
              "step": torch.tensor(4, dtype=torch.int32)}
    jckpt.save(jstate, str(tmp_path / "j"), 4)
    tckpt.save(tstate, str(tmp_path / "t"), 4)

    def manifest(d):
        with open(os.path.join(d, "step_00000004", "manifest.json")) as f:
            return [(m["key"], m["shape"], m["dtype"])
                    for m in json.load(f)["leaves"]]
    assert manifest(tmp_path / "t") == manifest(tmp_path / "j")

    # reference -> port
    got = tckpt.restore(str(tmp_path / "j"),
                        {"params": params_from_numpy(
                            jax.tree.map(np.zeros_like,
                                         jax.tree.map(np.asarray, jp)),
                            tm.cfg, device="cpu"),
                         "opt": to.init(tp),
                         "step": torch.zeros((), dtype=torch.int32)})
    assert int(got["step"]) == 4
    for (pa, a), (pb, b) in zip(_paths(params_to_numpy(got["params"])),
                                _paths(jax.tree.map(np.asarray, jp))):
        assert pa == pb and a.shape == b.shape and np.array_equal(a, b)
    # port -> reference
    back = jckpt.restore(str(tmp_path / "t"),
                         jax.tree.map(jnp.zeros_like, jstate))
    assert int(back["step"]) == 4
    for (pa, a), (pb, b) in zip(
            _paths(jax.tree.map(np.asarray, back["params"])),
            _paths(params_to_numpy(tp))):
        assert pa == pb and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_heartbeat_and_watchdog(tmp_path):
    live = tft.Heartbeat(str(tmp_path / "hb" / "a.json"), host_id=0)
    stale = tft.Heartbeat(str(tmp_path / "hb" / "b.json"), host_id=1)
    never = tft.Heartbeat(str(tmp_path / "hb" / "c.json"), host_id=2)
    live.beat(3, loss=1.5)
    stale.beat(1)
    with open(stale.path) as f:
        rec = json.load(f)
    rec["time"] -= 100.0
    with open(stale.path, "w") as f:
        json.dump(rec, f)
    with open(live.path) as f:
        assert json.load(f)["step"] == 3
    assert 0 <= live.age() < 10 and stale.age() > 99
    assert never.age() is None
    assert tft.watchdog([live, stale, never], max_age_s=30) == [1, 2]


def test_step_timer_flags_stragglers():
    t = tft.StepTimer(straggler_factor=2.0, warmup=2)
    flags = []
    for dt in (0.1, 0.1, 0.1, 0.1, 0.5, 0.1):
        t.start()
        t._t0 -= dt          # a step of ~dt seconds, without sleeping
        flags.append(t.stop()["straggler"])
    assert flags == [False, False, False, False, True, False]
    assert t.stragglers == 1


def test_run_with_restarts():
    attempts = []

    def flaky(attempt):
        attempts.append(attempt)
        if attempt < 2:
            raise RuntimeError("lost a worker")
        return 42
    assert tft.run_with_restarts(flaky, max_restarts=3) == 42
    assert attempts == [0, 1, 2]
    calls = []

    def always(attempt):
        calls.append(attempt)
        raise OSError("disk gone")
    with pytest.raises(OSError):
        tft.run_with_restarts(always, max_restarts=1)
    assert calls == [0, 1]
    with pytest.raises(KeyError):
        tft.run_with_restarts(lambda a: {}["x"], max_restarts=5)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _cfg():
    return TC.reduced(TC.get("qwen3-1.7b")).hashed_variant(0.125)


def test_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    kw = dict(batch=2, seq=16, device="cpu", log_every=0)
    first = tlaunch.run(_cfg(), steps=4, ckpt_dir=ck, ckpt_every=2, **kw)
    assert tckpt.available_steps(ck) == [2, 4]
    assert first["final_step"] == 4 and len(first["losses"]) == 4
    saved = tckpt.restore(ck, first["state"])
    for (pa, a), (pb, b) in zip(_paths(saved), _paths(first["state"])):
        assert pa == pb and torch.equal(a, b)
    second = tlaunch.run(_cfg(), steps=6, ckpt_dir=ck, ckpt_every=2, **kw)
    assert "restored checkpoint @ step 4" in capsys.readouterr().out
    assert second["final_step"] == 6 and len(second["losses"]) == 2
    whole = tlaunch.run(_cfg(), steps=6, **kw)
    np.testing.assert_allclose(first["losses"] + second["losses"],
                               whole["losses"], rtol=0, atol=1e-6)
    with open(os.path.join(ck, "heartbeat.json")) as f:
        assert json.load(f)["step"] == 5
    assert second["straggler_count"] >= 0 and len(second["step_times"]) == 2


@pytest.mark.parametrize("kind", ["hashed_space", "int8"])
def test_launcher_grad_compress_end_to_end(kind, capsys):
    assert tlaunch.main(["--arch", "qwen3-1.7b", "--reduced", "--hashed",
                         "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16", "--grad-compress", kind]) == 0
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[-2]) == {"final_step": 3,
                                                "straggler_count": 0}
    plain = tlaunch.run(_cfg(), steps=1, batch=2, seq=16, device="cpu",
                        log_every=0)
    comp = tlaunch.run(_cfg(), steps=2, batch=2, seq=16, device="cpu",
                       log_every=0, grad_compressor=kind)
    # compression acts after the loss: the first step's loss is the same
    assert comp["losses"][0] == plain["losses"][0]
    assert np.isfinite(comp["losses"][1])
    assert "residual" in comp["state"]


def test_sigterm_to_a_child_launcher_saves_and_exits_cleanly(tmp_path):
    ck = tmp_path / "ck"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--reduced", "--hashed", "--device", "cpu",
         "--steps", "100000", "--batch", "2", "--seq", "16", "--ckpt-dir",
         str(ck), "--ckpt-every", "100000"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        seen, deadline = [], time.monotonic() + 120
        while not any(line.startswith("step") for line in seen):
            left = deadline - time.monotonic()
            assert left > 0, f"no step line in 120 s: {seen}"
            ready, _, _ = select.select([child.stdout], [], [], left)
            if ready:
                line = child.stdout.readline()
                assert line, f"child ended early: {child.stderr.read()}"
                seen.append(line)
        child.send_signal(signal.SIGTERM)
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, err[-3000:]
    assert "preemption: emergency checkpoint saved, exiting cleanly" in out
    step = tckpt.latest_step(str(ck))
    assert step is not None and 1 <= step < 100000
