"""Device selection for the port's entry points.

``build``, ``Engine`` and ``launch.serve`` run on the card unless the
caller asks for the CPU; with no CUDA device and no explicit CPU request
they raise instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions on "
                "the CPU")
        # fp32 products in full fp32, never TF32, on the card path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
