"""Hand-written CUDA kernels of the PyTorch port, one per Pallas kernel on
the serving path, each with its plain PyTorch version beside it.

Every wrapper counts its kernel launches (``<wrapper>.launches``) and
every plain version counts the calls it was given CUDA tensors
(``<plain>.cuda_calls``), so a run can show that the main path went
through the kernels and not through a plain version.  Importing this
package builds nothing: a kernel is compiled with ``nvcc`` at its first
launch (``_build``).
"""
from repro_torch.kernels.flash_prefill import (paged_prefill_attention,
                                               paged_prefill_ref)
from repro_torch.kernels.hashed_matmul import element_matmul, hashed_matmul_ref
from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                 paged_decode_attention)
from repro_torch.kernels.topk import topk_mask, topk_mask_ref

# kernel name -> (wrapper, plain version, CUDA source)
KERNELS = {
    "hashed_matmul": (element_matmul, hashed_matmul_ref,
                      "src/repro_torch/kernels/csrc/hashed_matmul.cu"),
    "paged_decode": (paged_decode_attention, paged_attention_ref,
                     "src/repro_torch/kernels/csrc/paged_attention.cu"),
    "paged_prefill": (paged_prefill_attention, paged_prefill_ref,
                      "src/repro_torch/kernels/csrc/flash_prefill.cu"),
    "topk_mask": (topk_mask, topk_mask_ref,
                  "src/repro_torch/kernels/csrc/topk.cu"),
}


def reset_counts() -> None:
    for wrapper, plain, _ in KERNELS.values():
        wrapper.launches = 0
        plain.cuda_calls = 0


def counts() -> dict:
    """{name: {"launches": kernel launches, "plain_cuda_calls": plain
    version calls on CUDA tensors}}."""
    return {name: {"launches": wrapper.launches,
                   "plain_cuda_calls": plain.cuda_calls}
            for name, (wrapper, plain, _) in KERNELS.items()}
