"""The device an entry point runs on: CUDA unless the caller asks for
another (the tests pass ``device="cpu"``), and ``full_f32``, the
precision every entry point's ``main`` sets before it builds a model."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The given device, else CUDA. Without a CUDA device and without an
    explicit ``device="cpu"`` this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


def full_f32() -> None:
    """Turn TF32 off for this process, in cuBLAS matmuls and cuDNN convs
    alike: the port's f32 paths are held to the JAX package at 1e-4, and
    PyTorch's default runs cuDNN convs in TF32 (~1e-3). Every CLI's
    ``main`` calls it; a library caller who wants the port's f32 numbers
    calls it too (importing the port changes no flag)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
