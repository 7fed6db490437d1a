"""Atomic checkpoints of a train state, PyTorch port of the JAX package's
``train/checkpoint.py``, in its on-disk format.

Layout (one directory per step)::

    <dir>/step_00000042/
        manifest.json      # step, time, and per leaf: key, file, shape, dtype
        arr_00000.npy ...  # one .npy per leaf, in sorted-key order
    <dir>/step_00000042.done   # commit marker -> atomic visibility

- **Atomicity**: the writer fills ``step_X.tmp``, renames it and then
  drops the ``.done`` marker; readers consider marked steps only, so a
  preemption mid-write never yields half a checkpoint.
- **keep-k GC** of the oldest committed steps after each save.
- **Keys** are JAX's ``keystr`` form (``['params']/['layers']/...``), so
  the two packages read each other's checkpoints.
- **bf16 leaves** are written as the JAX package writes its
  ``ml_dtypes.bfloat16`` arrays (``.npy`` descr ``'<V2'``, manifest dtype
  ``"bfloat16"``) and read back by reinterpreting the 2-byte values'
  bits, so no ``ml_dtypes`` is needed.

Tensors move to the host with ``.cpu()``; ``restore`` puts every leaf on
the device and dtype of the matching leaf of its target.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


def _flatten(tree, prefix: str = "") -> List[Tuple[str, object]]:
    """(keystr, leaf) pairs in JAX's flatten order: dict keys sorted,
    lists and tuples in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}/[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}/[{i}]")]
    return [(prefix[1:], tree)]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)
    return build(like)


def _save_leaf(path: str, t: torch.Tensor) -> Tuple[list, str]:
    """Write one leaf as ``.npy``; returns (shape, manifest dtype)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(bits.shape)})
            f.write(bits.tobytes())
        return list(bits.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _load_leaf(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16" and arr.dtype.kind == "V":
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(state, directory: str, step: int, keep: int = 3,
         on_save: Optional[Callable[[str, Any, int], None]] = None) -> str:
    """Write one atomic checkpoint; returns its path.

    on_save: optional hook called after the commit marker lands with
    ``(final_path, state, step)``: the artifact exporter rides here, so
    every committed checkpoint can also mint a deployable compressed
    artifact.  Hook errors are raised, not swallowed: a failed export
    fails before the GC can reap the checkpoint it shadowed."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "time": time.time(), "leaves": []}
    for i, (key, leaf) in enumerate(_flatten(state)):
        fname = f"arr_{i:05d}.npy"
        shape, dtype = _save_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append({"key": key, "file": fname,
                                   "shape": shape, "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)                      # atomic rename
    with open(final + ".done", "w") as f:      # commit marker
        f.write(str(step))
    if on_save is not None:
        on_save(final, state, int(step))
    _gc(directory, keep)
    return final


def artifact_exporter(cfg, artifact_dir: str,
                      registry_root: Optional[str] = None,
                      model_name: Optional[str] = None,
                      keep: int = 3):
    """An ``on_save`` hook that exports ``state["params"]`` as a compressed
    artifact (``artifact_dir/model_<step>.hnart``) at each committed
    checkpoint, and with ``registry_root`` registers it as the next
    version of ``model_name`` (default the config's name), the policy in
    the registry metadata.

    keep: only the newest ``keep`` exports stay in artifact_dir; the
    registry's copies are immutable and never pruned."""
    from repro_torch import artifact as art

    def hook(final_path: str, state, step: int) -> None:
        path = os.path.join(artifact_dir, f"model_{step:08d}.hnart")
        art.export_model(path, cfg, state["params"],
                         meta={"step": step, "checkpoint": final_path})
        if registry_root:
            from repro_torch import policy as pol
            from repro_torch.artifact import registry as reg
            meta = {"step": step}
            if getattr(cfg, "hash_policy", None) is not None:
                meta["hash_policy"] = pol.policy_to_dict(cfg.hash_policy)
            reg.register(registry_root, model_name or cfg.name, path,
                         metadata=meta)
        if keep > 0:
            old = sorted(f for f in os.listdir(artifact_dir)
                         if f.startswith("model_")
                         and f.endswith(".hnart"))[:-keep]
            for f in old:
                os.remove(os.path.join(artifact_dir, f))
    return hook


def _gc(directory: str, keep: int) -> None:
    steps = available_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        name = os.path.join(directory, f"step_{s:08d}")
        for p in (name + ".done", name):
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            elif os.path.exists(p):
                os.remove(p)


def available_steps(directory: str) -> List[int]:
    """Committed steps, ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for entry in os.listdir(directory):
        m = _STEP_RE.match(entry)
        if m and os.path.exists(os.path.join(directory, entry + ".done")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, target, step: Optional[int] = None,
            prefix: Optional[str] = None):
    """Load a checkpoint (default the latest committed step) into the
    structure of ``target``, a tree of tensors: each leaf comes back with
    the shape, dtype and device of its target leaf.

    ``prefix`` (a key such as ``"['params']"``) restores one subtree of
    the saved state: ``target`` is shaped like that subtree, and each of
    its leaves is the saved leaf whose key is ``prefix/<its own key>``.
    Leaves are matched by key only; a key missing on either side
    raises.  This loads the params of a whole train state whatever its
    optimizer state holds."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    kv = _flatten(target)
    by_key = {m["key"]: m for m in manifest["leaves"]}
    if prefix is not None:
        kv = [(f"{prefix}/{key}", tgt) for key, tgt in kv]
        saved = {k for k in by_key if k.startswith(prefix + "/")}
        missing = sorted({key for key, _ in kv} - saved)
        extra = sorted(saved - {key for key, _ in kv})
        if missing or extra:
            raise ValueError(
                f"checkpoint subtree {prefix} does not match the target: "
                f"missing {missing[:4]}, unexpected {extra[:4]}")
    elif len(kv) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, target has "
            f"{len(kv)} — structure mismatch")
    leaves = []
    for i, (key, tgt) in enumerate(kv):
        meta = by_key[key] if prefix is not None \
            else by_key.get(key) or manifest["leaves"][i]
        t = _load_leaf(os.path.join(path, meta["file"]), meta["dtype"])
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"{key}: ckpt {tuple(t.shape)} != target "
                             f"{tuple(tgt.shape)}")
        leaves.append(t.to(device=tgt.device, dtype=tgt.dtype))
    return _unflatten(target, leaves)
