"""Cold-start loading: mmap the artifact, view its sections, one copy to
the device (the PyTorch port of the JAX package's ``artifact/io.py``).

The sections are 64-byte aligned typed blobs, so loading is::

    mm   = np.memmap(path, np.uint8, "c")            # no read, just map
    leaf = torch.from_numpy(mm[off:off + n].view(dtype).reshape(shape))
    leaf.to(device)                                  # the one H2D copy

No model ``init`` runs, no treedef is needed from a live model (the
header's paths rebuild the tree), and nothing of the virtual matrices is
materialized: the HashedSpecs ride in the header and the model
decompresses on the fly.  The map is copy-on-write (``"c"``): the views
are writable without a copy, so ``torch.from_numpy`` takes them as they
are, and a write to a CPU-loaded leaf lands in a private page, never in
the file.  bf16 and fp8 sections are viewed through same-width integers
and reinterpreted by torch (no ``ml_dtypes``).

Quantized leaves are dequantized on the host by default (one pass, then
the one H2D copy of the restored dtype).  ``dequant=False`` returns
:class:`repro_torch.artifact.quant.Quantized` leaves (their codes and
scales numpy views into the map) for a consumer that ships the codes as
they are; no kernel of the port takes them (the JAX package has none).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.artifact import format as F
from repro_torch.artifact import quant as Q


def open_artifact(path: str) -> Tuple[dict, np.memmap]:
    header = F.read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    return header, mm


def _view(mm: np.memmap, data_start: int, offset: int, nbytes: int,
          dtype: str, shape) -> np.ndarray:
    start = data_start + offset
    return Q.numpy_view(mm[start:start + nbytes], dtype).reshape(shape)


def read_leaf(header: dict, mm: np.memmap, entry: dict,
              dequant: bool = True):
    """One leaf: a CPU tensor viewing the map (a dequantized copy for a
    quantized leaf), or with ``dequant=False`` a ``Quantized``."""
    ds = header["data_start"]
    z = entry.get("quant")
    if z is None:
        return Q.from_bits(_view(mm, ds, entry["offset"], entry["nbytes"],
                                 entry["stored_dtype"], entry["shape"]),
                           entry["stored_dtype"])
    q = _view(mm, ds, entry["offset"], entry["nbytes"],
              entry["stored_dtype"], (z["num_groups"], z["group"]))
    scales = _view(mm, ds, z["scales_offset"], z["scales_nbytes"],
                   "float32", (z["num_groups"],))
    zq = Q.Quantized(q=q, scales=scales, scheme=z["scheme"],
                     group=z["group"], pad=z["pad"],
                     orig_shape=tuple(entry["shape"]),
                     orig_dtype=entry["dtype"])
    return zq.dequantize() if dequant else zq


def load(path: str, *, dequant: bool = True,
         device=None) -> Tuple[dict, object]:
    """Load an artifact -> (header, params tree).  ``device`` (default the
    card; "cpu" keeps the leaves as views into the map): every tensor
    leaf is copied there once."""
    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)
    header, mm = open_artifact(path)
    entries = []
    for e in header["leaves"]:
        leaf = read_leaf(header, mm, e, dequant=dequant)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(dev)
        entries.append((tuple(e["path"]), leaf))
    return header, F.unflatten_from_paths(entries)


def with_exec_path(cfg, path: str):
    """``cfg`` with every hashed projection's execution path set to
    ``path`` (the flat knob, the policy's default and each rule that
    names one): an execution hint only, no HashedSpec changes."""
    cfg = cfg.with_(hash_path=path)
    pol = cfg.hash_policy
    if pol is None:
        return cfg
    rules = tuple(dataclasses.replace(r, path=path) if r.path is not None
                  else r for r in pol.rules)
    return cfg.with_(hash_policy=dataclasses.replace(pol, path=path,
                                                     rules=rules))


def load_model(path: str, *, dequant: bool = True, device=None):
    """Artifact -> (cfg, model, params): the one-call cold start.  The
    model is rebuilt from the stored ArchConfig on ``device`` (default
    the card) and the params land there directly.  Its hashed
    projections take the hand-written kernels ("pallas"), whatever path
    the writer's config names (the JAX package's default is its "scan"
    path)."""
    from repro_torch.core.device import resolve_device
    from repro_torch.models import build
    dev = resolve_device(device)
    header, params = load(path, dequant=dequant, device=dev)
    if not header.get("config"):
        raise ValueError(f"{path}: artifact has no model config; "
                         f"use artifact.io.load for raw param trees")
    cfg = with_exec_path(F.config_from_dict(header["config"]), "pallas")
    return cfg, build(cfg, device=dev), params
