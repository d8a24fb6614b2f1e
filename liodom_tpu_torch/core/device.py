"""Where the port's entry points run."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or left as the default) and
    there is none — nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("liodom_tpu_torch runs on CUDA by default and no "
                           "CUDA device is available; pass device='cpu' to "
                           "run the plain PyTorch path")
    return dev
