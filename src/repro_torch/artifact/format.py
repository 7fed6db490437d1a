"""Single-file compressed model artifact: JSON header + aligned sections
(the PyTorch port of the JAX package's ``artifact/format.py``, in its
on-disk format: either package reads the other's files).

Layout (little-endian)::

    bytes 0..8    magic  b"HNETART1"
    bytes 8..16   u64 header length H
    bytes 16..16+H JSON header (utf-8)
    pad to 64-byte boundary
    section data  (each section 64-byte aligned)

The header carries everything needed to rebuild the model with no other
input: the ArchConfig dict, and per leaf its tree path, stored dtype,
shape, section offset, the serialized ``HashedSpec`` of hashed banks (the
bank and hash seeds fully determine the virtual matrix) and the
quantization metadata (scheme / group / scales section) of a leaf
quantized at export.  Dense leaves are stored as they are, hashed layers
store only their ``c x`` smaller bank: the virtual weights are recomputed
at load, never stored.  Alignment makes every section directly mmap-able
into a typed view (zero-copy cold start, ``artifact.io``).

Tree paths are JSON lists of dict keys (strings) and list indices
(integers), in ``jax.tree_util``'s flatten order (``train.optimizer``'s
tree helpers): enough to rebuild the nested dict/list trees of the
decoder stacks and the paper's MLPs without a live model's treedef.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.artifact import quant as Q
from repro_torch.core import hashed as H

MAGIC = b"HNETART1"
ALIGN = 64
FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# tree <-> (path, leaf) lists
# ---------------------------------------------------------------------------

def flatten_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path tuple, leaf) pairs in ``jax.tree_util`` order: dict keys
    sorted (as strings in the path), lists and tuples in order (integer
    indices), ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def unflatten_from_paths(entries: List[Tuple[Tuple, Any]]):
    """Rebuild a nested dict/list tree from (path, value) pairs."""
    if not entries:
        return {}
    if len(entries) == 1 and entries[0][0] == ():
        return entries[0][1]
    root: Dict = {}
    for path, value in entries:
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value

    def finalize(node):
        if not isinstance(node, dict):
            return node
        out = {k: finalize(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out):
            idxs = sorted(out)
            if idxs == list(range(len(idxs))):
                return [out[i] for i in idxs]
        return out

    return finalize(root)


# ---------------------------------------------------------------------------
# config serialization
# ---------------------------------------------------------------------------

def config_to_dict(cfg) -> dict:
    from repro_torch import policy as POL
    d = dataclasses.asdict(cfg)
    d["hash_block"] = list(d["hash_block"])
    if cfg.hash_policy is not None:
        d["hash_policy"] = POL.policy_to_dict(cfg.hash_policy)
    return d


def config_from_dict(d: dict):
    """The port's ``ArchConfig`` from a header's config dict; keys this
    reader does not know (a newer writer's) are dropped, policy keys
    too."""
    from repro_torch import policy as POL
    from repro_torch.configs.base import ArchConfig
    kw = dict(d)
    kw["hash_block"] = tuple(kw.get("hash_block", (128, 128)))
    if kw.get("hash_policy"):
        kw["hash_policy"] = POL.policy_from_dict(kw["hash_policy"],
                                                 strict=False)
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in kw.items() if k in fields}
    return ArchConfig(**kw)


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def _aligned(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write(path: str, params, *, config: Optional[dict] = None,
          bank_specs: Optional[Dict[Tuple, H.HashedSpec]] = None,
          quant: str = "none", quant_group: int = 64,
          quant_min_size: int = 4096,
          quant_overrides: Optional[Dict[Tuple, str]] = None,
          meta: Optional[dict] = None) -> dict:
    """Serialize ``params`` (a tree of tensors or numpy arrays) into one
    artifact file; returns the header.

    bank_specs: leaf path tuple -> HashedSpec of hashed banks (layer
    stacking adds leading axes: the leaf then holds ``stack`` banks and
    its element count is a multiple of ``spec.real_param_count()``).
    quant_overrides: leaf path tuple -> scheme, overriding ``quant`` for
    that leaf (``"none"`` exempts it).  The file is written to
    ``path + ".tmp"`` and renamed into place.
    """
    if quant not in Q.SCHEMES:
        raise ValueError(f"quant must be one of {Q.SCHEMES}")
    quant_overrides = quant_overrides or {}
    for p, scheme in quant_overrides.items():
        if scheme not in Q.SCHEMES:
            raise ValueError(f"quant override for {p}: {scheme!r} "
                             f"not in {Q.SCHEMES}")
    bank_specs = bank_specs or {}

    leaves = []
    blobs: List[bytes] = []
    offset = 0

    def add_section(data: bytes) -> Tuple[int, int]:
        nonlocal offset
        start = offset
        blobs.append(data)
        offset = _aligned(start + len(data))
        blobs.append(b"\x00" * (offset - start - len(data)))
        return start, len(data)

    for p, leaf in flatten_with_paths(params):
        if not isinstance(leaf, torch.Tensor):
            leaf = np.asarray(leaf)
        arr, dtype = Q.to_host(leaf)
        spec = bank_specs.get(p)
        entry: Dict[str, Any] = {
            "path": list(p), "kind": "bank" if spec is not None else "dense",
            "shape": [int(s) for s in arr.shape], "dtype": dtype,
            "spec": spec.to_dict() if spec is not None else None,
        }
        if spec is not None:
            rp = spec.real_param_count()
            if arr.size % rp:
                raise ValueError(
                    f"leaf {p}: size {arr.size} is not a multiple of the "
                    f"spec's real_param_count {rp}: bank_specs mismatch")
            entry["stack"] = int(arr.size // rp)
        scheme = quant_overrides.get(p, quant)
        if scheme != "none" and Q.should_quantize(
                p, leaf, spec is not None, min_size=quant_min_size):
            z = Q.quantize(leaf, scheme, quant_group)
            qoff, qn = add_section(z.q.tobytes())
            soff, sn = add_section(z.scales.tobytes())
            entry.update({
                "offset": qoff, "nbytes": qn,
                "stored_dtype": Q.stored_dtype(scheme),
                "quant": {"scheme": z.scheme, "group": z.group,
                          "pad": z.pad, "num_groups": int(z.scales.size),
                          "scales_offset": soff, "scales_nbytes": sn},
            })
        else:
            doff, dn = add_section(arr.tobytes())
            entry.update({"offset": doff, "nbytes": dn,
                          "stored_dtype": dtype, "quant": None})
        leaves.append(entry)

    header = {
        "format": "hashednet-artifact",
        "version": FORMAT_VERSION,
        "alignment": ALIGN,
        "config": config,
        "quant": quant,
        "leaves": leaves,
        "meta": meta or {},
    }
    hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
    header["data_start"] = _aligned(len(MAGIC) + 8 + len(hjson))
    # re-encode with data_start included (its length may grow; re-align)
    for _ in range(3):
        hjson = json.dumps(header, separators=(",", ":")).encode("utf-8")
        new_start = _aligned(len(MAGIC) + 8 + len(hjson))
        if new_start == header["data_start"]:
            break
        header["data_start"] = new_start
    preamble = MAGIC + struct.pack("<Q", len(hjson)) + hjson
    pad = header["data_start"] - len(preamble)

    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(preamble)
        f.write(b"\x00" * pad)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)          # atomic visibility, as checkpoints
    return header


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

def read_header(path: str) -> dict:
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a hashednet artifact "
                             f"(magic {magic!r})")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode("utf-8"))
    if header.get("version", 0) > FORMAT_VERSION:
        raise ValueError(f"{path}: artifact version {header['version']} "
                         f"is newer than this reader ({FORMAT_VERSION})")
    return header
