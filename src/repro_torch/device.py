"""The port's device rule: a GPU unless the caller asks for the CPU.

Every entry point that places data (``bucketize``, ``convert.state_from_arrays``,
``launch.decompose``) defaults to ``"cuda"`` and resolves it here, so a
machine without a GPU raises instead of running quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``cuda`` (or ``cuda:N``) needs a GPU and raises without one; ``cpu``
    is explicit. On CUDA, float32 products are kept in full float32 (TF32
    off for matmuls and cuDNN), and a bfloat16/float16 product reduces in
    float32 (cuBLAS's reduced-precision reductions off), as the reference's
    half products accumulate."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unknown device {device!r}; choose 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the port runs on a GPU "
                           "by default; pass device='cpu' (--device cpu on the "
                           "command line) to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    return dev
