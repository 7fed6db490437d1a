"""Paged flash-decode: one decode step of GQA attention through a paged
KV cache.

Kernel: ``csrc/paged_attention.cu`` (CUDA C++, sm_90a).  It replaces the
JAX package's ``kernels/paged_attention.py`` ``_decode_kernel`` /
``paged_decode_attention``.  Flash-decoding: the row's KV positions are
cut into chunks of ``DECODE_CHUNK`` (one block per kv head, row and
chunk; :func:`decode_chunks` per row of the table), each block stages
its live positions' K and V rows through the page table into shared
memory and writes the chunk's fp32 (m, l, acc); a second pass merges
the chunks in chunk order (the same bits on every launch).  Chunks
wholly outside the row's window or length exit at once, which adds
exactly the zero weight the TPU kernel's masking gives them.  What
bounds it on the H100 is bytes (every live K/V token read once, at
about four flops per byte) and, at serving's batch sizes, the latency
of the dependent length, table and K/V loads.  Page 0 is the trash
page; unused table slots point at it and are masked through
``lengths``; rows with ``length == 0`` give zeros.

The plain version :func:`paged_attention_ref` (the port of the JAX
package's ``kernels/ref.py`` ``paged_attention_ref``) gathers the whole
table and attends.  The CPU path takes it; on a CUDA tensor the wrapper
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NEG = -1e30
DECODE_CHUNK = 64      # KV positions per block (csrc kChunk)


def decode_chunks(max_pages: int, page_size: int) -> int:
    """Chunks the split-KV decode cuts a row of ``max_pages`` table slots
    into: ceil(max_pages * page_size / DECODE_CHUNK), at least one."""
    return max(1, -(-max_pages * page_size // DECODE_CHUNK))


def paged_attention_ref(q, pages_k, pages_v, page_table, lengths, window=0):
    """Decode attention through a paged KV cache, gather-then-attend.

    q (B, Hq, D) rotated, scaled by 1/sqrt(D) here; pages_k/v
    (P, ps, Hkv, D); page_table (B, MAXP) int32 (unused slots -> trash
    page 0); lengths (B,) counts INCLUDING the current token; window 0
    disables.  Returns (B, Hq, D) in q.dtype.
    """
    if q.is_cuda:
        paged_attention_ref.cuda_calls += 1
    b, hq, d = q.shape
    _, ps, n_kv, _ = pages_k.shape
    g = hq // n_kv
    table = page_table.long()
    t = table.shape[1] * ps
    k = pages_k[table].reshape(b, t, n_kv, d).float()
    v = pages_v[table].reshape(b, t, n_kv, d).float()
    qg = q.reshape(b, n_kv, g, d).float() / (d ** 0.5)
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k)
    kv_pos = torch.arange(t, device=q.device)[None, :]
    lengths = lengths.long()
    valid = kv_pos < lengths[:, None]
    if window > 0:
        valid = valid & ((lengths - 1)[:, None] - kv_pos < window)
    vmask = valid[:, None, None, :]
    scores = torch.where(vmask, scores, torch.tensor(NEG, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    # a fully masked row (idle decode slot, length 0) softmaxes to a
    # uniform distribution over garbage; zero it instead
    probs = torch.where(vmask, probs, 0.0)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v)
    return out.reshape(b, hq, d).to(q.dtype)


paged_attention_ref.cuda_calls = 0


def paged_decode_attention(q, pages_k, pages_v, page_table, lengths,
                           window: int = 0):
    """One decode step of attention through a paged KV cache.

    q: (B, Hq, D) current-token queries, rotated to position
    ``lengths - 1``; pages_k/v: (P, page_size, Hkv, D) physical page pool
    (page 0 is the trash page); page_table: (B, MAXP) int32; lengths:
    (B,) int32 valid cached tokens per row INCLUDING the current token;
    window: sliding-window size, 0 disables.  Returns (B, Hq, D) in
    q.dtype.
    """
    if q.device.type == "cpu":
        return paged_attention_ref(q, pages_k, pages_v, page_table, lengths,
                                   window)
    _build.require_cuda(q, "paged_decode_attention")
    b, hq, d = q.shape
    npages, ps, n_kv, dk = pages_k.shape
    if dk != d or hq % n_kv or pages_v.shape != pages_k.shape:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} vs "
                         f"pages {tuple(pages_k.shape)}")
    g = hq // n_kv
    if d not in (64, 128, 256) or g not in (1, 2, 4, 8):
        raise ValueError(f"paged_decode_attention: head_dim {d} / group {g} "
                         f"not compiled (head_dim 64/128/256, group 1-8)")
    if q.dtype not in _build.DTYPE_CODE or pages_k.dtype != q.dtype \
            or pages_v.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and pages must share "
                         "dtype float32 or bfloat16")
    q = _build.aligned16(q.contiguous())
    if not (pages_k.is_contiguous() and pages_v.is_contiguous()):
        raise ValueError("paged_decode_attention: page pools must be "
                         "contiguous")
    if pages_k.data_ptr() % 16 or pages_v.data_ptr() % 16:
        raise ValueError("paged_decode_attention: page pools must start "
                         "on a 16-byte boundary")
    table = page_table.to(device=q.device, dtype=torch.int32).contiguous()
    lens = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    maxp = table.shape[1]
    n_chunks = decode_chunks(maxp, ps)
    out = torch.empty_like(q)
    # the chunks' partials: acc (B, Hq, chunks, D), then (m, l)
    ws = torch.empty(b * hq * n_chunks * (d + 2), dtype=torch.float32,
                     device=q.device)
    fn = _build.bind("paged_attention", "paged_decode",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    rc = fn(_build.ptr(q), _build.ptr(pages_k), _build.ptr(pages_v),
            _build.ptr(table), _build.ptr(lens), _build.ptr(out),
            _build.ptr(ws), b, n_kv, g, d, maxp, ps, n_chunks, int(window),
            _build.DTYPE_CODE[q.dtype], _build.stream_of(q))
    _build.check(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
