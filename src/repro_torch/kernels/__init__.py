"""Hand-written CUDA kernels of the PyTorch port, one per Pallas kernel of
the JAX package, each with its plain PyTorch version beside it.

Every wrapper counts its kernel launches (``<wrapper>.launches``; those
of a kernel with a tensor-core body also ``<wrapper>.tensor_core``) and
every plain version counts the calls it was given CUDA tensors
(``<plain>.cuda_calls``), so a run can show that the main path went
through the kernels and not through a plain version.  Importing this
package builds nothing: a kernel is compiled with ``nvcc`` at its first
launch (``_build``).
"""
from repro_torch.kernels.flash_prefill import (paged_prefill_attention,
                                               paged_prefill_ref)
from repro_torch.kernels.hashed_matmul import (block_dw, block_matmul,
                                               element_dw, element_matmul,
                                               element_matmul_t,
                                               hashed_dw_ref,
                                               hashed_matmul_ref,
                                               hashed_matmul_t_ref)
from repro_torch.kernels.paged_attention import (paged_attention_ref,
                                                 paged_decode_attention)
from repro_torch.kernels.topk import topk_mask, topk_mask_ref

_CSRC = "src/repro_torch/kernels/csrc/"

# kernel name -> (wrapper, its plain versions, CUDA source); one entry per
# Pallas kernel of the JAX package (block_matmul runs both orientations,
# as the JAX block_matmul does)
KERNELS = {
    "hashed_matmul": (element_matmul, (hashed_matmul_ref,),
                      _CSRC + "hashed_matmul.cu"),
    "hashed_matmul_t": (element_matmul_t, (hashed_matmul_t_ref,),
                        _CSRC + "hashed_matmul.cu"),
    "hashed_dw": (element_dw, (hashed_dw_ref,), _CSRC + "hashed_dw.cu"),
    "block_matmul": (block_matmul, (hashed_matmul_ref, hashed_matmul_t_ref),
                     _CSRC + "hashed_block.cu"),
    "block_dw": (block_dw, (hashed_dw_ref,), _CSRC + "hashed_block.cu"),
    "paged_decode": (paged_decode_attention, (paged_attention_ref,),
                     _CSRC + "paged_attention.cu"),
    "paged_prefill": (paged_prefill_attention, (paged_prefill_ref,),
                      _CSRC + "flash_prefill.cu"),
    "topk_mask": (topk_mask, (topk_mask_ref,), _CSRC + "topk.cu"),
}


def reset_counts() -> None:
    for wrapper, plains, _ in KERNELS.values():
        wrapper.launches = 0
        for plain in plains:
            plain.cuda_calls = 0
    block_matmul.transposed = 0
    element_matmul.gemv = element_matmul.tensor_core = 0
    element_matmul.small = 0
    topk_mask.resident = 0
    element_dw.tensor_core = 0
    block_dw.tensor_core = 0
    paged_prefill_attention.tensor_core = 0


def counts() -> dict:
    """{name: {"launches": kernel launches, "plain_cuda_calls": calls of
    its plain versions on CUDA tensors}}; ``block_matmul`` also reports
    how many of its launches were transposed, ``hashed_dw``
    (``element_dw``), ``block_dw`` and ``paged_prefill`` how many ran
    their tensor-core body, ``hashed_matmul`` (``element_matmul``) how
    many ran the tensor-core and the gemv body and how many had at most
    ``GEMV_MAX_ROWS`` rows (``small``), ``topk_mask`` how many held
    every row in its cluster's shared memory (``resident``)."""
    out = {name: {"launches": wrapper.launches,
                  "plain_cuda_calls": sum(p.cuda_calls for p in plains)}
           for name, (wrapper, plains, _) in KERNELS.items()}
    out["block_matmul"]["transposed"] = block_matmul.transposed
    for body in ("tensor_core", "gemv", "small"):
        out["hashed_matmul"][body] = getattr(element_matmul, body)
    out["topk_mask"]["resident"] = topk_mask.resident
    out["hashed_dw"]["tensor_core"] = element_dw.tensor_core
    out["block_dw"]["tensor_core"] = block_dw.tensor_core
    out["paged_prefill"]["tensor_core"] = paged_prefill_attention.tensor_core
    return out
