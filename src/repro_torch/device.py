"""The device rule of the port: entry points run on the card unless the
caller asks for the CPU.

``resolve_device(None)`` is ``cuda``; when CUDA is not available it raises
rather than quietly running on the CPU. An explicit ``"cpu"`` (what the
tests pass) or any other device string / ``torch.device`` is taken as
asked.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
