"""The device the port's entry points run on when the caller names none.

The port runs on the CUDA card.  An entry point given ``device=None``
resolves to ``torch.device("cuda")``; on a machine without CUDA that is
an error that says how to ask for the CPU (``device="cpu"``, which runs
every kernel's plain PyTorch version).  It never falls back to the CPU
by itself.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the CUDA card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "pyfem_gpu_testflight_tpu_torch runs on a CUDA card and none "
            "is available; pass device='cpu' to run on the CPU (each "
            "kernel's plain PyTorch version)"
        )
    return torch.device("cuda")
