"""float32 pin for every matrix product and convolution on the card.

Hopper twin of ``pyfem_gpu_testflight_tpu/ops/precision.py``: there the
TPU's bf16 matmul default wrecked isoparametric Jacobians, so every
einsum requests ``Precision.HIGHEST``.  On an H100 the same trap is
TF32 (10-bit mantissa): PyTorch leaves cuDNN convolutions in TF32 by
default and lets ``set_float32_matmul_precision`` drop matmuls to it.
The package pins both off at import, so "float32" means IEEE float32.
"""

from __future__ import annotations

import torch

__all__ = ["pin_fp32"]


def pin_fp32():
    """Turn TF32 off for matmuls and cuDNN; full-precision float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
