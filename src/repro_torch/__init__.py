"""PyTorch/CUDA port of the HashedNets serving stack (``repro``).

Runs on an NVIDIA GPU by default, with hand-written CUDA kernels for the
hashed decompress-GEMM, paged decode attention, ragged paged prefill and
the sampler's top-k mask; ``device="cpu"`` runs each kernel's plain
PyTorch version instead.  Imports ``torch`` and never ``jax`` or the JAX
package.
"""
