"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, bound with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  Libraries land in the
checkout's ``build/kernels/`` directory (listed in ``.gitignore``) under
a name that carries a digest of the sources and flags, so an edited
source never loads a stale library.  The build runs at first use; a
caller that wants all of it up front (``chip_smoke.py``) calls
:func:`build`, which starts one ``nvcc`` per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NAMES = ("hashed_matmul", "hashed_dw", "hashed_block", "paged_attention",
         "flash_prefill", "topk")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

# dtype codes shared with the C entry points
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built at first use and need the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source started
    together.  Returns seconds per library built now (0.0 if it was
    already there).  Raises with the compiler's output on failure."""
    names = tuple(names or NAMES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, out = {}, {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            out[name] = 0.0
            continue
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        log = open(dst.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       time.perf_counter(), tmp, dst, log)
    failed = []
    for name, (proc, t0, tmp, dst, log) in procs.items():
        rc = proc.wait()
        out[name] = time.perf_counter() - t0
        log.close()
        if rc != 0:
            failed.append(f"{name}:\n{dst.with_suffix('.log').read_text()}")
            continue
        os.replace(tmp, dst)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory lines for a built kernel."""
    log = lib_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    return "\n".join(line for line in log.read_text().splitlines()
                     if "registers" in line or "smem" in line
                     or "spill" in line)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        path = lib_path(name)
        if not path.exists():
            build([name])
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def bind(name: str, fn: str, argtypes):
    """A C entry point with its ``ctypes`` argument types declared
    (``c_void_p`` for every pointer and the stream, ``c_int`` /
    ``c_uint`` / ``c_float`` for scalars).  Every entry point returns
    ``cudaGetLastError()`` after its launches."""
    key = (name, fn)
    if key not in _fns:
        f = getattr(lib(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[key] = f
    return _fns[key]


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"(cudaGetLastError)")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when its data does not start on the 16-byte
    boundary that the kernels' 16-byte copies (``cp.async``) need."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what}: tensor on {t.device}; the kernel takes "
                         f"CUDA tensors and the plain version CPU ones")
