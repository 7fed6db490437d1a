"""Tiny versioned model registry for cold-start serving (the PyTorch
port's copy of the JAX package's ``artifact/registry.py``: either package
reads the other's registry).

Layout (one directory, fully self-contained and rsync-able)::

    <root>/registry.json                  # atomic index
    <root>/<name>/v0001.hnart ...         # immutable artifact files

``registry.json``::

    {"models": {"<name>": {"latest": 2, "versions": {
        "1": {"file": "<name>/v0001.hnart", "sha256": ..., "bytes": ...,
              "created": ..., "metadata": {...}}, ...}}}}

Properties:
- **Immutable versions**: registering always mints a new version; files
  are copied in under the registry root then the index is atomically
  replaced (tmp + os.replace), so readers never see a half-registered
  model — same commit discipline as the checkpointer.
- **Integrity**: sha256 recorded at register time; ``resolve`` re-hashes
  by default and refuses a corrupt artifact (serving cold-start safety).
- **No daemon**: it's a directory; the engine resolves name[@version] to
  a file path and mmaps it.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, Optional

INDEX = "registry.json"


def _index_path(root: str) -> str:
    return os.path.join(root, INDEX)


def _load_index(root: str) -> dict:
    p = _index_path(root)
    if not os.path.exists(p):
        return {"models": {}}
    with open(p) as f:
        return json.load(f)


def _store_index(root: str, index: dict) -> None:
    tmp = _index_path(root) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(index, f, indent=1, sort_keys=True)
    os.replace(tmp, _index_path(root))


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class _Lock:
    """Advisory cross-process lock: mkdir is atomic on POSIX, so the
    directory doubles as the mutex.  Registration is a read-modify-write
    of the index plus a version-numbered copy — two concurrent trainers
    registering the same name would otherwise both claim version N+1 and
    overwrite each other's artifact after its sha256 was recorded."""

    def __init__(self, root: str, timeout_s: float = 30.0):
        self.path = os.path.join(root, ".registry.lock")
        self.timeout_s = timeout_s

    def __enter__(self):
        # monotonic, not wall: an NTP step during acquisition must neither
        # spuriously raise TimeoutError nor extend the wait unboundedly
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                os.mkdir(self.path)
                return self
            except FileExistsError:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"registry lock {self.path} held for "
                        f">{self.timeout_s}s; remove it if its owner died")
                time.sleep(0.05)

    def __exit__(self, *exc):
        os.rmdir(self.path)


def register(root: str, name: str, artifact_path: str, *,
             metadata: Optional[dict] = None) -> int:
    """Copy an artifact into the registry as the next version of ``name``;
    returns the new version number.  Safe under concurrent registrations:
    the byte copy and sha256 run OUTSIDE the lock (they can take minutes
    for multi-GB artifacts on network storage); the lock only covers the
    version claim + a rename + the index update, so it is held for
    milliseconds and a healthy concurrent registrant never times out."""
    os.makedirs(os.path.join(root, name), exist_ok=True)
    staging = os.path.join(root, name,
                           f".staging.{os.getpid()}.{time.time_ns()}")
    shutil.copyfile(artifact_path, staging)
    digest = sha256_file(staging)
    nbytes = os.path.getsize(staging)
    try:
        with _Lock(root):
            index = _load_index(root)
            model = index["models"].setdefault(
                name, {"latest": 0, "versions": {}})
            version = int(model["latest"]) + 1
            rel = os.path.join(name, f"v{version:04d}.hnart")
            os.replace(staging, os.path.join(root, rel))
            model["versions"][str(version)] = {
                "file": rel,
                "sha256": digest,
                "bytes": nbytes,
                "created": time.time(),
                "metadata": metadata or {},
            }
            model["latest"] = version
            _store_index(root, index)
    finally:
        if os.path.exists(staging):
            os.remove(staging)
    return version


def resolve(root: str, name: str, version: Optional[int] = None, *,
            verify: bool = True) -> Dict[str, Any]:
    """name[@version] -> entry dict with an absolute ``path`` added.

    verify: re-hash the file and raise on mismatch (default on — a corrupt
    artifact must fail the cold start, not serve garbage logits)."""
    if "@" in name and version is None:
        name, _, v = name.partition("@")
        version = int(v)
    index = _load_index(root)
    if name not in index["models"]:
        known = sorted(index["models"])
        raise KeyError(f"model {name!r} not in registry {root} "
                       f"(known: {known})")
    model = index["models"][name]
    # explicit None check: version 0 must fail like any missing version,
    # not fall through to latest
    version = int(model["latest"]) if version is None else int(version)
    entry = model["versions"].get(str(version))
    if entry is None:
        raise KeyError(f"{name}@{version} not found "
                       f"(latest: {model['latest']})")
    out = dict(entry)
    out["name"], out["version"] = name, version
    out["path"] = os.path.join(root, entry["file"])
    if verify:
        got = sha256_file(out["path"])
        if got != entry["sha256"]:
            raise ValueError(
                f"{name}@{version}: integrity check failed "
                f"(sha256 {got[:12]}.. != recorded "
                f"{entry['sha256'][:12]}..)")
    return out


def list_models(root: str) -> Dict[str, Any]:
    return _load_index(root)["models"]
