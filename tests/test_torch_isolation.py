"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

- In a subprocess with ``sys.modules["jax"]`` and
  ``sys.modules["ml_dtypes"]`` set to None (so any import of either
  fails), import ``repro_torch``, serve two requests on the CPU, then a
  greedy and a seeded sampled request with ``batched_prefill=False``, train
  two steps through ``launch.train`` (with a checkpoint and gradient
  compression), run the hashed GEMM's forward and backward wrappers in
  both modes, import the paper's MLPs, their data and the trainer's
  checkpoint, fault-tolerance and compression modules and fit a small
  hashed MLP, export a bf16 model as an int8 and an fp8 ``.hnart``
  artifact, register it and cold-start a speculative engine from the
  registry with a 1/16 draft (its tokens equal the non-speculative
  engine's), list the registry through ``registry_cli``, and check that
  nothing of ``repro`` was imported.
- An AST scan of ``src/repro_torch/**``, ``chip_smoke.py`` and
  ``gemm_timing.py``: no JAX import, no ``ml_dtypes`` (the card's machine
  has none) and no import of the JAX package.
- Without a CUDA device, the entry points raise unless asked for the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
sys.modules["jax"] = None            # any JAX import now fails
sys.modules["ml_dtypes"] = None      # nor may ml_dtypes be imported
import numpy as np
import repro_torch
import repro_torch.configs as C
from repro_torch.models import build
from repro_torch.serving.engine import Engine, Request
cfg = C.reduced(C.get("qwen3-1.7b")).hashed_variant(0.125)
model = build(cfg, device="cpu")
eng = Engine(model, model.init(0), device="cpu", max_len=32, eos_id=-1)
for uid in range(2):
    assert eng.submit(Request(uid=uid, prompt=np.arange(5, dtype=np.int32)
                              + 2 + uid, max_new_tokens=3))
done = eng.run()
assert sorted(len(r.tokens) for r in done) == [3, 3], done
from repro_torch.serving.api import SamplingParams
eng = Engine(model, model.init(0), device="cpu", max_len=32, eos_id=-1,
             batched_prefill=False)
assert eng.submit(Request(uid=0, prompt=np.arange(6, dtype=np.int32) + 2,
                          max_new_tokens=3))
assert eng.submit(Request(uid=1, prompt=np.arange(4, dtype=np.int32) + 9,
                          sampling=SamplingParams(temperature=0.8, top_k=5,
                                                  seed=3, max_tokens=3)))
done = eng.run()
assert sorted(len(r.tokens) for r in done) == [3, 3], done
import torch
from repro_torch.launch import train
from repro_torch.train import optimizer, step  # noqa: F401
from repro_torch.core.hashed import HashedSpec
from repro_torch.kernels import ops
import tempfile
with tempfile.TemporaryDirectory() as ck:
    assert train.main(["--arch", "qwen3-1.7b", "--reduced", "--hashed",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "8", "--ckpt-dir", ck,
                       "--grad-compress", "int8"]) == 0
from repro_torch.data import mnist_synthetic
from repro_torch.paper import mlp as pmlp, train as ptrain
from repro_torch.train import checkpoint, fault_tolerance, grad_compress  # noqa: F401
x, y = mnist_synthetic.load("rect", "train", n=100)
spec = pmlp.MLPSpec((784, 16, 2), method="hashed", compression=1 / 8)
params, hist = ptrain.fit(spec, x, y, ptrain.TrainConfig(epochs=1),
                          device="cpu")
assert 0.0 <= ptrain.evaluate(spec, params, x, y) <= 1.0
for spec in (HashedSpec((32, 64), 0.25, panel_cols=32),
             HashedSpec((32, 64), 0.25, mode="block", block_shape=(16, 32))):
    w = torch.zeros(spec.real_param_shape(), requires_grad=True)
    x = torch.ones(3, 5, 32, requires_grad=True)
    ops.hashed_matmul(x, w, spec).sum().backward()
    assert w.grad.shape == w.shape and x.grad.shape == x.shape
from repro_torch import artifact
from repro_torch.artifact import registry
from repro_torch.launch import registry_cli
from repro_torch.serving import draft, spec_decode  # noqa: F401
cfg = C.reduced(C.get("qwen3-1.7b")).hashed_variant(0.125)
params = build(cfg, device="cpu").init(0)
with tempfile.TemporaryDirectory() as d:
    for q in ("int8", "fp8"):
        artifact.export_model(d + "/m.hnart", cfg, params, quant=q)
        _, loaded = artifact.load(d + "/m.hnart", device="cpu")
    artifact.export_model(d + "/m.hnart", cfg, params)
    registry.register(d + "/reg", "toy", d + "/m.hnart")
    toks = []
    for pol in (None, "1/16"):
        eng = Engine.from_artifact("toy", registry_root=d + "/reg",
                                   device="cpu", max_len=32, eos_id=-1,
                                   draft_policy=pol, spec_k=2)
        assert eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32)
                                  + 2, max_new_tokens=4))
        toks.append([r.tokens for r in eng.run()])
    assert toks[0] == toks[1], toks
    assert registry_cli.main(["--registry", d + "/reg", "verify"]) == 0
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m == "repro" or m.startswith("repro.") or m == "jax"
                  or m.startswith("jax.") or m.startswith("jaxlib")
                  or m == "ml_dtypes"))
print("LEAKED", bad)
"""


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_serves_on_cpu_with_jax_blocked_in_a_subprocess():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["OMP_NUM_THREADS"] = "2"
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LEAKED []" in out.stdout, out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_imports_in_port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "gemm_timing.py"]
    assert len(files) > 20
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax",
                       "ml_dtypes"):
                bad.append(f"{f.relative_to(ROOT)}: {mod}")
    assert bad == []


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import repro_torch.configs as C
    from repro_torch.models import build
    from repro_torch.serving.engine import Engine
    from repro_torch.launch import serve
    cfg = C.reduced(C.get("qwen3-1.7b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    model = build(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(model, model.init(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"])
    from repro_torch.paper import mlp, train as ptrain
    spec = mlp.MLPSpec((784, 8, 10), method="hashed", compression=0.125)
    x = np.zeros((50, 784), np.float32)
    y = np.zeros(50, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.fit(spec, x, y, ptrain.TrainConfig(epochs=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.init(spec, torch.Generator())
    params, _ = ptrain.fit(spec, x, y, ptrain.TrainConfig(epochs=1),
                           device="cpu")
    assert params[0]["w"].device.type == "cpu"
    assert Engine(model, model.init(0), device="cpu").device.type == "cpu"


def test_cpu_tensors_never_reach_a_kernel_launch():
    """On the CPU every wrapper runs its plain version and counts no
    launch; the build module is never asked for nvcc."""
    from repro_torch import kernels as K
    from repro_torch.kernels import topk
    before = K.counts()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16)).astype(np.float32))
    topk.topk_mask(x, torch.tensor([3, 0], dtype=torch.int32))
    assert K.counts() == before
