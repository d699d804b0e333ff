"""The port's device rule: entry points run on the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA card and raises when there is none;
    anything else is taken as given (tests pass ``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
