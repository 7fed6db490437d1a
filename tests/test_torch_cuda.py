"""The CUDA kernels of the PyTorch port against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode.  The file imports neither JAX nor the JAX
package, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.)  Tolerances: fp32
max error <= 1e-5 x the largest plain value (the sums run in another
order); bf16 <= 1e-2 x (one rounding of the output); the top-k mask
bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import hashed as TH
from repro_torch.kernels import flash_prefill as TFP
from repro_torch.kernels import hashed_matmul as THK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import topk as TTK


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _topk_case():
    rng = np.random.default_rng(3)
    v = 200
    x = rng.standard_normal((6, v)).astype(np.float32)
    x[2, :30] = 1.25                  # ties straddling the threshold
    x[3] = 0.0
    x[3, 1::2] = -0.0                 # +-0.0 at the threshold
    x[3, :5] = 2.0
    k = np.array([0, -3, 10, 20, v, 1], np.int32)   # k<=0, k>=V disable
    return torch.from_numpy(x), torch.from_numpy(k)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 37, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hashed_matmul_vs_plain(cuda_device, m, dtype):
    spec = TH.HashedSpec(virtual_shape=(1024, 768), compression=0.125,
                         seed=9, panel_cols=256)
    g = torch.Generator(device=cuda_device).manual_seed(m)
    w = torch.randn(spec.num_buckets, generator=g, device=cuda_device) \
        .to(dtype)
    x = torch.randn(m, 1024, generator=g, device=cuda_device).to(dtype)
    before = THK.element_matmul.launches
    got = TOPS.hashed_matmul(x, w, spec)
    assert THK.element_matmul.launches == before + 1
    want = THK.hashed_matmul_ref(x, w, spec)
    scale = want.float().abs().max().item()
    # fp32: sum order only; bf16: one rounding of the output
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert (got.float() - want.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 24])
def test_cuda_paged_decode_vs_plain(cuda_device, window):
    g = torch.Generator(device=cuda_device).manual_seed(window)
    pk = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    pv = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    table = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0], [5, 6, 7, 8]],
                         dtype=torch.int32, device=cuda_device)
    lengths = torch.tensor([50, 0, 64], dtype=torch.int32,
                           device=cuda_device)
    q = torch.randn(3, 4, 128, generator=g, device=cuda_device)
    got = TPA.paged_decode_attention(q, pk, pv, table, lengths, window)
    want = TPA.paged_attention_ref(q, pk, pv, table, lengths, window)
    assert (got - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    assert got[1].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 20])
def test_cuda_paged_prefill_vs_plain(cuda_device, window):
    g = torch.Generator(device=cuda_device).manual_seed(window)
    pk = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    pv = torch.randn(20, 16, 2, 128, generator=g, device=cuda_device)
    table = torch.tensor([[1, 2, 3, 4], [0, 0, 0, 0], [1, 6, 7, 8]],
                         dtype=torch.int32, device=cuda_device)
    starts = torch.tensor([10, 0, 16], dtype=torch.int32, device=cuda_device)
    counts = torch.tensor([40, 0, 23], dtype=torch.int32, device=cuda_device)
    q = torch.randn(3, 40, 4, 128, generator=g, device=cuda_device)
    got = TFP.paged_prefill_attention(q, pk, pv, table, starts, counts,
                                      window)
    want = TFP.paged_prefill_ref(q, pk, pv, table, starts, counts, window)
    assert (got - want).abs().max().item() \
        <= 1e-5 * want.abs().max().item()
    assert got[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_topk_mask_vs_plain_bitwise(cuda_device):
    x, k = _topk_case()
    got = TTK.topk_mask(x.to(cuda_device), k.to(cuda_device))
    assert torch.equal(got.cpu(), TTK.topk_mask_ref(x, k))
    bf = x.to(torch.bfloat16)
    got = TTK.topk_mask(bf.to(cuda_device), k.to(cuda_device))
    assert torch.equal(got.cpu(), TTK.topk_mask_ref(bf, k))


@pytest.mark.cuda
def test_cuda_engine_greedy_tokens_match_cpu_plain_path(cuda_device):
    """The whole serving path on the card (every kernel) against the
    CPU plain path, fp32, small model with head_dim 64 (the attention
    kernels compile head_dim 64/128/256): identical greedy tokens with
    prefix caching and chunked, batched prefill."""
    import repro_torch.configs as C
    from repro_torch import kernels as K
    from repro_torch.models import build
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = C.reduced(C.get("qwen3-1.7b")).hashed_variant(0.125).with_(
        dtype="float32", head_dim=64, hash_panel_cols=32)
    cpu_model = build(cfg, device="cpu")
    params = cpu_model.init(0)
    rng = np.random.default_rng(0)
    shared = rng.integers(2, cfg.vocab_size, size=20)
    prompts = [np.concatenate([shared, rng.integers(2, cfg.vocab_size,
                                                    size=n)])
               for n in (3, 9, 17, 1, 30)]

    def run(device, model, p):
        eng = Engine(model, p, device=device, max_concurrency=3, max_len=64,
                     eos_id=-1, page_size=8, prefix_cache=True,
                     prefill_chunk=16,
                     scheduler=SchedulerConfig(max_queue=8,
                                               max_prefills_per_tick=3))
        for uid, pr in enumerate(prompts):
            assert eng.submit(Request(uid=uid, prompt=pr.astype(np.int32),
                                      max_new_tokens=6))
        eng.run()
        eng.kv.leak_check()
        return {r.uid: r.tokens for r in eng._done}

    want = run("cpu", cpu_model, params)

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(cuda_device)
    gpu_params = to_dev(params)
    K.reset_counts()
    got = run("cuda", build(cfg, device="cuda"), gpu_params)
    counts = K.counts()
    assert got == want
    assert all(c["launches"] > 0 for c in
               (counts["hashed_matmul"], counts["paged_decode"],
                counts["paged_prefill"]))
    assert all(c["plain_cuda_calls"] == 0 for c in counts.values())
