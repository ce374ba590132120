"""The device an entry point runs on: CUDA unless the caller asks for
another (the tests pass ``device="cpu"``)."""
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
