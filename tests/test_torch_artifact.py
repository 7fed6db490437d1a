"""The port's compressed artifacts against the JAX package's.

- ``.hnart`` files go both ways: the JAX package's export loads into the
  port with every leaf bitwise (bf16 too), the port's loads into the JAX
  package the same way, and the port's leaf paths are
  ``repro.artifact.format.flatten_with_paths``'s.
- int8 and fp8 codes and scales are bitwise the JAX package's (zeros,
  bf16 leaves and values at the fp8 edge included) and the round trip
  stays within ``max_abs_error``; ``report.report`` prints the JAX
  package's text for the same file.
- Loading is a zero-copy map: a CPU-loaded leaf's storage is the file's
  mapped section.
- The registry (versions, integrity refusal, the monotonic lock timeout,
  version 0), ``checkpoint.save(on_save=)`` and ``artifact_exporter``
  through ``launch.train``, the paper MLP's ``export_tree``,
  ``Engine.from_artifact`` (tokens of an engine on the same params and of
  the JAX engine, greedy and seeded), the int8 artifact's logits, and the
  launchers: ``serve --artifact`` / ``--model-name --registry`` and
  ``registry_cli``.
"""
import contextlib
import io
import json
import os
import re

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro import artifact as jart
from repro.artifact import format as jfmt
from repro.artifact import quant as jquant
from repro.configs.reduced import reduced as jreduced
from repro.models import build as jbuild
from repro.serving.api import SamplingParams as JSP
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import Request as JRequest

import repro_torch.configs as TC
from repro_torch import artifact as tart
from repro_torch import policy as TPOL
from repro_torch.artifact import format as tfmt
from repro_torch.artifact import io as tio
from repro_torch.artifact import quant as tquant
from repro_torch.artifact import registry as treg
from repro_torch.artifact import report as treport
from repro_torch.interop import params_from_numpy
from repro_torch.launch import registry_cli, serve
from repro_torch.launch import train as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.serving.api import SamplingParams
from repro_torch.serving.engine import Engine, Request
from repro_torch.train import checkpoint as tckpt

_REQ = re.compile(r"^req (\d+): (\[[^\]]*\])  \(finish=(\w+)")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as uint8 (a tensor, numpy or ml_dtypes array)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        return t.view(torch.uint8).numpy().reshape(-1) if t.numel() \
            else np.zeros(0, np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


@pytest.fixture(scope="module")
def bf16_models():
    """Reduced hashed qwen3 in bf16: the JAX params and the port's copy."""
    jc = jreduced(JC.get("qwen3-1.7b")).hashed_variant(0.125)
    tc = TC.reduced(TC.get("qwen3-1.7b")).hashed_variant(0.125)
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


@pytest.fixture(scope="module")
def f32_models():
    jc = jreduced(JC.get("qwen3-1.7b")).with_(
        dtype="float32").hashed_variant(0.125)
    tc = TC.reduced(TC.get("qwen3-1.7b")).with_(
        dtype="float32").hashed_variant(0.125)
    jm = jbuild(jc)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jm, jp, tc, tbuild(tc, device="cpu"), tp


# ---------------------------------------------------------------------------
# files both ways
# ---------------------------------------------------------------------------

def test_jax_written_artifact_loads_into_port_bitwise(bf16_models, tmp_path):
    jc, jp, tc, _ = bf16_models
    path = str(tmp_path / "jax.hnart")
    jart.export_model(path, jc, jp)
    cfg, model, params = tio.load_model(path, device="cpu")
    assert cfg == tc                     # the writer's "scan" -> "pallas"
    assert tfmt.config_from_dict(tfmt.read_header(path)["config"]) \
        == tc.with_(hash_path="scan")
    want = jfmt.flatten_with_paths(jp)
    got = tfmt.flatten_with_paths(params)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[str(np.asarray(b).dtype)]
        assert tuple(a.shape) == np.shape(b), p
        assert np.array_equal(_bits(a), _bits(b)), p
    assert model.init_shapes()["layers"]["attn"]["q"]["w"] \
        == tuple(params["layers"]["attn"]["q"]["w"].shape)


def test_port_written_artifact_loads_into_jax_bitwise(bf16_models, tmp_path):
    jc, jp, tc, tp = bf16_models
    path = str(tmp_path / "port.hnart")
    header = tart.export_model(path, tc, tp)
    assert [tuple(e["path"]) for e in header["leaves"]] == \
        [p for p, _ in jfmt.flatten_with_paths(jp)]
    jh, loaded = jart.load(path, as_jax=False)
    assert jfmt.config_from_dict(jh["config"]).with_(hash_path="scan") == jc
    for (p, a), (_, b) in zip(jfmt.flatten_with_paths(loaded),
                              tfmt.flatten_with_paths(tp)):
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), p
        assert np.array_equal(_bits(a), _bits(b)), p


def test_cpu_load_is_a_view_of_the_mapped_file(bf16_models, tmp_path):
    """No copy before the host-to-device copy: each CPU leaf's storage is
    its section of the map, bf16 leaves reinterpreted in place."""
    _, _, tc, tp = bf16_models
    path = str(tmp_path / "m.hnart")
    tart.export_model(path, tc, tp)
    header, mm = tio.open_artifact(path)
    base = mm.ctypes.data + header["data_start"]
    dtypes = set()
    for e in header["leaves"]:
        t = tio.read_leaf(header, mm, e)
        assert t.data_ptr() == base + e["offset"], e["path"]
        dtypes.add(t.dtype)
    assert dtypes == {torch.bfloat16, torch.float32}


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def _quant_input(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((37, 53)) * 3).astype(np.float32)
    x[0, :20] = 0.0                    # a zero run
    x[2, :] = 0.0                      # groups of zeros only
    x[4, 0] = 1e-30                    # subnormal after scaling
    x[6, :3] = (5.0, -5.0, 4.9999995)  # ties to the group absmax
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_quant_codes_and_scales_bitwise_reference(scheme, dtype):
    x = _quant_input(np.float32 if dtype == "float32"
                     else ml_dtypes.bfloat16)
    xt = torch.from_numpy(np.asarray(x).view(np.int16)).view(torch.bfloat16) \
        if dtype == "bfloat16" else torch.from_numpy(x)
    zj = jquant.quantize(x, scheme, group=64)
    zt = tquant.quantize(xt, scheme, group=64)
    assert np.array_equal(np.asarray(zj.q).view(np.uint8),
                          zt.q.view(np.uint8))
    assert np.array_equal(zj.scales, zt.scales)
    assert (zt.pad, zt.orig_shape, zt.orig_dtype) == \
        (zj.pad, zj.orig_shape, zj.orig_dtype)
    back = tquant.dequantize(zt)
    assert back.dtype == xt.dtype and tuple(back.shape) == x.shape
    assert np.array_equal(_bits(back), _bits(jquant.dequantize(zj)))
    err = float((back.float() - xt.float()).abs().max())
    # a bf16 leaf's restore cast adds at most half a bf16 ulp of |x|
    cast = 0.0 if dtype == "float32" else 2.0 ** -8 * float(
        xt.float().abs().max())
    assert err <= tquant.max_abs_error(scheme, zt.scales) + cast + 1e-7
    assert float(back.float()[2].abs().max()) == 0.0


def test_fp8_cast_saturates_a_hair_above_448():
    """x/s a hair above 448 rounds to 448 (code 0x7e), never to NaN, as
    ml_dtypes rounds it."""
    s = np.array([[448.0, np.nextafter(np.float32(448.0), np.float32(500)),
                   447.99997, -448.00003, 0.0, 300.0]], np.float32)
    got = tquant._fp8_bits(s)
    want = np.asarray(s.astype(ml_dtypes.float8_e4m3fn)).view(np.uint8)
    assert np.array_equal(got, want)
    assert got[0, 1] == 0x7E


def test_unflatten_mixed_dict_list():
    tree = {"a": [{"w": np.arange(3)}, {"w": np.arange(2)}],
            "b": {"c": np.ones(1)}, "d": (np.zeros(2), None)}
    entries = tfmt.flatten_with_paths(tree)
    assert [p for p, _ in entries] == \
        [p for p, _ in jfmt.flatten_with_paths(tree)]
    back = tfmt.unflatten_from_paths(entries)
    assert isinstance(back["a"], list) and len(back["a"]) == 2
    np.testing.assert_array_equal(back["a"][1]["w"], np.arange(2))
    np.testing.assert_array_equal(back["b"]["c"], np.ones(1))
    assert isinstance(back["d"], list) and len(back["d"]) == 1


def test_report_text_equals_reference(tmp_path):
    pol = TPOL.CompressionPolicy(
        rules=(TPOL.PolicyRule(match="layers.attn.*", compression=0.25),
               TPOL.PolicyRule(match="layers.ffn.out", quant="fp8")),
        compression=0.125)
    tc = TC.reduced(TC.get("qwen3-1.7b")).policy_variant(pol)
    model = tbuild(tc, device="cpu")
    path = str(tmp_path / "pol.hnart")
    header = tart.export_model(path, tc, model.init(0), quant="int8",
                               quant_min_size=256)
    kinds = {e["quant"]["scheme"] for e in header["leaves"] if e["quant"]}
    assert kinds == {"int8", "fp8"}
    text = treport.report(path)
    assert text == jart.report.report(path)
    assert "by policy rule" in text and "layers.attn.*" in text


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_versions_and_integrity(tmp_path):
    art = str(tmp_path / "a.hnart")
    tart.export_tree(art, {"w": np.arange(100, dtype=np.float32)})
    root = str(tmp_path / "reg")
    assert (treg.register(root, "toy", art, metadata={"step": 1}),
            treg.register(root, "toy", art, metadata={"step": 2})) == (1, 2)
    e = treg.resolve(root, "toy")
    assert e["version"] == 2 and e["metadata"]["step"] == 2
    assert treg.resolve(root, "toy@1")["version"] == 1
    # the JAX package reads the port's registry and the other way round
    assert jart.registry.resolve(root, "toy@2")["sha256"] == e["sha256"]
    with open(e["path"], "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\xFF")
    with pytest.raises(ValueError, match="integrity"):
        treg.resolve(root, "toy")
    with pytest.raises(KeyError):
        treg.resolve(root, "nope")
    with pytest.raises(KeyError):
        treg.resolve(root, "toy@0")
    with pytest.raises(KeyError):
        treg.resolve(root, "toy", version=0)


def test_registry_lock_timeout_survives_wall_clock_step(tmp_path,
                                                        monkeypatch):
    """The lock times out on the monotonic clock: a wall clock stepping
    backwards while another process holds the lock cannot extend the
    wait."""
    root = str(tmp_path / "reg")
    os.makedirs(root)
    lock = treg._Lock(root, timeout_s=1.0)
    os.mkdir(lock.path)              # another process holds the lock
    mono = [100.0]
    wall = [1e9]

    def monotonic():
        mono[0] += 0.1
        return mono[0]

    def wall_time():
        wall[0] -= 3600.0
        return wall[0]

    monkeypatch.setattr(treg.time, "monotonic", monotonic)
    monkeypatch.setattr(treg.time, "time", wall_time)
    monkeypatch.setattr(treg.time, "sleep", lambda s: None)
    with pytest.raises(TimeoutError):
        lock.__enter__()
    assert mono[0] - 100.0 < 5.0
    os.rmdir(lock.path)
    with lock:
        assert os.path.isdir(lock.path)
    assert not os.path.isdir(lock.path)


# ---------------------------------------------------------------------------
# checkpoint export hook, train launcher
# ---------------------------------------------------------------------------

def test_checkpoint_on_save_runs_after_the_commit(f32_models, tmp_path):
    _, _, _, tc, _, tp = f32_models
    seen = []

    def hook(final, state, step):
        seen.append((final, os.path.exists(final + ".done"), step))
    ck = str(tmp_path / "ck")
    final = tckpt.save({"params": tp, "step": torch.tensor(7)}, ck, 7,
                       on_save=hook)
    assert seen == [(final, True, 7)]
    adir, root = str(tmp_path / "art"), str(tmp_path / "reg")
    os.makedirs(adir)
    hook = tckpt.artifact_exporter(tc, adir, registry_root=root,
                                   model_name="qwen-ckpt", keep=1)
    for step in (8, 9):
        tckpt.save({"params": tp, "step": torch.tensor(step)}, ck, step,
                   on_save=hook)
    assert os.listdir(adir) == ["model_00000009.hnart"]   # keep=1
    header = tfmt.read_header(os.path.join(adir, "model_00000009.hnart"))
    assert header["meta"]["step"] == 9
    assert {tuple(e["path"])[0] for e in header["leaves"]} == \
        {"embed", "layers", "final_norm"}
    e = treg.resolve(root, "qwen-ckpt")
    assert (e["version"], e["metadata"]["step"]) == (2, 9)


def test_train_launcher_exports_and_registers(tmp_path, capsys):
    ck, adir, root = (str(tmp_path / n) for n in ("ck", "art", "reg"))
    args = ["--arch", "qwen3-1.7b", "--reduced", "--hashed", "--device",
            "cpu", "--steps", "2", "--batch", "2", "--seq", "8"]
    assert tlaunch.main(args + ["--ckpt-dir", ck, "--ckpt-every", "1",
                                "--artifact-dir", adir, "--registry", root,
                                "--artifact-quant", "int8"]) == 0
    assert sorted(os.listdir(adir)) == ["model_00000001.hnart",
                                        "model_00000002.hnart"]
    name = TC.reduced(TC.get("qwen3-1.7b")).hashed_variant(0.125).name
    e = treg.resolve(root, name)
    assert e["version"] == 2 and e["metadata"]["step"] == 2
    header = tfmt.read_header(e["path"])
    assert header["config"]["artifact_quant"] == "int8"
    assert any(x["quant"] and x["quant"]["scheme"] == "int8"
               for x in header["leaves"])
    for bad, msg in (
            (["--artifact-quant", "int8"], "require --artifact-dir"),
            (["--registry", root], "require --artifact-dir"),
            (["--artifact-dir", adir], "requires --ckpt-dir")):
        with pytest.raises(SystemExit):
            tlaunch.main(args + bad)
        assert msg in capsys.readouterr().err


def test_mlp_export_tree_roundtrip(tmp_path):
    from repro_torch.paper import mlp
    spec = mlp.MLPSpec((784, 64, 10), method="hashed", compression=1 / 8)
    g = torch.Generator().manual_seed(0)
    params = mlp.init(spec, g, device="cpu")
    banks = {(l, "w"): spec.hashed_spec(l) for l in range(spec.n_layers)}
    x = torch.randn(4, 784, generator=g)
    want = mlp.apply(spec, params, x)
    for quant in ("none", "int8"):
        path = str(tmp_path / f"mlp_{quant}.hnart")
        tart.export_tree(path, params, bank_specs=banks, quant=quant)
        header, loaded = tart.load(path, device="cpu")
        assert isinstance(loaded, list) and len(loaded) == spec.n_layers
        got = mlp.apply(spec, loaded, x)
        if quant == "none":
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) < 0.15 * (
                float(want.abs().max()) + 1.0)
    rows = treport.artifact_rows(header)
    assert [r for r in rows if r["kind"] == "bank"]
    _, jl = jart.load(path, as_jax=False)          # the JAX reader too
    assert len(jl) == spec.n_layers


# ---------------------------------------------------------------------------
# cold start
# ---------------------------------------------------------------------------

def _sps():
    return [None, JSP(temperature=0.9, top_p=0.9, seed=7, max_tokens=6),
            None, JSP(temperature=0.7, top_k=20, seed=3, max_tokens=6)]


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab, n).astype(np.int32) for n in (5, 9, 7, 12)]


def _serve(eng, req_cls, sp_cls, vocab):
    for uid, (p, sp) in enumerate(zip(_prompts(vocab), _sps())):
        sp = None if sp is None else sp_cls(**{
            k: getattr(sp, k) for k in ("temperature", "top_p", "top_k",
                                        "seed", "max_tokens")})
        assert eng.submit(req_cls(uid=uid, prompt=p.copy(), max_new_tokens=6,
                                  sampling=sp))
    return {r.uid: list(r.tokens) for r in eng.run()}


def test_engine_from_artifact_matches_live_params_and_reference(
        f32_models, tmp_path):
    jc, jm, jp, tc, tm, tp = f32_models
    path = str(tmp_path / "m.hnart")
    jart.export_model(path, jc, jp)
    root = str(tmp_path / "reg")
    treg.register(root, "toy", path)
    kw = dict(slots=2, max_len=64, eos_id=-1)
    want = _serve(JEngine.from_artifact(path, page_size=8, **kw), JRequest,
                  JSP, jc.vocab_size)
    live = _serve(Engine(tm, tp, device="cpu", page_size=8, **kw), Request,
                  SamplingParams, tc.vocab_size)
    cold = _serve(Engine.from_artifact("toy", registry_root=root,
                                       device="cpu", page_size=8, **kw),
                  Request, SamplingParams, tc.vocab_size)
    assert cold == live == want
    assert all(len(t) == 6 for t in cold.values())


def test_int8_artifact_logits_within_reference_bound(f32_models, tmp_path):
    """The bound of the JAX package's
    ``test_transformer_artifact_int8_tolerance``: logits within 10% of
    their scale."""
    _, _, _, tc, tm, tp = f32_models
    path = str(tmp_path / "m8.hnart")
    tart.export_model(path, tc, tp, quant="int8")
    _, m2, p2 = tart.load_model(path, device="cpu")
    toks = torch.tensor([[5, 9, 2, 7]])
    l1, _ = tm.prefill(tp, {"tokens": toks, "cache": tm.init_cache(1, 32)})
    l2, _ = m2.prefill(p2, {"tokens": toks, "cache": m2.init_cache(1, 32)})
    denom = float(l1.abs().max()) + 1e-6
    assert float((l1 - l2).abs().max()) / denom < 0.1
    assert not torch.equal(l1, l2)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def _launch(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(argv)
    got = {}
    for line in out.getvalue().splitlines():
        m = _REQ.match(line)
        if m:
            got[int(m.group(1))] = json.loads(m.group(2))
    return rc, got, out.getvalue()


def test_serve_launcher_artifact_and_registry(f32_models, tmp_path, capsys):
    _, _, _, tc, tm, tp = f32_models
    path = str(tmp_path / "m.hnart")
    tart.export_model(path, tc, tp)
    root = str(tmp_path / "reg")
    treg.register(root, "toy", path)
    eng = Engine(tm, tp, device="cpu", max_concurrency=4, max_len=256,
                 eos_id=-1)
    for uid, p in enumerate(serve.prompts(3, tc.vocab_size)):
        eng.submit(Request(uid=uid, prompt=p,
                           sampling=SamplingParams(max_tokens=4)))
    want = {r.uid: r.tokens for r in eng.run()}
    common = ["--device", "cpu", "--requests", "3", "--max-new", "4"]
    for src in (["--artifact", path],
                ["--model-name", "toy@1", "--registry", root]):
        rc, got, text = _launch(src + common)
        assert rc == 0 and got == want, text[-2000:]
        assert "cold start from artifact" in text
    for bad, msg in (
            (["--artifact", path, "--model-name", "toy"], "mutually"),
            (["--artifact", path, "--registry", root], "goes with"),
            (["--model-name", "toy"], "requires --registry"),
            (["--artifact", path, "--arch", "qwen3-1.7b"], "cannot be"),
            ([], "--arch is required")):
        with pytest.raises(SystemExit):
            serve.main(bad + common)
        assert msg in capsys.readouterr().err


def test_registry_cli_list_inspect_verify(tmp_path, capsys):
    art = str(tmp_path / "a.hnart")
    tart.export_tree(art, {"w": np.arange(64, dtype=np.float32)})
    root = str(tmp_path / "reg")
    treg.register(root, "toy", art, metadata={"step": 3})
    treg.register(root, "toy", art)
    assert registry_cli.main(["--registry", root, "--json", "list"]) == 0
    models = json.loads(capsys.readouterr().out)
    assert models["toy"]["latest"] == 2
    assert registry_cli.main(["--registry", root, "inspect", "toy@1"]) == 0
    assert "toy@1" in capsys.readouterr().out
    assert registry_cli.main(["--registry", root, "--json", "verify"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert (res["verified"], res["failed"]) == (2, 0)
    e = treg.resolve(root, "toy@1", verify=False)
    with open(e["path"], "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x01")
    assert registry_cli.main(["--registry", root, "verify"]) == 1
    assert "1 failed" in capsys.readouterr().out
    assert registry_cli.main(["--registry", str(tmp_path / "none"),
                              "list"]) == 2
