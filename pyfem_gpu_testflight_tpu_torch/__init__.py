"""pyfem_gpu_testflight_tpu_torch — PyTorch/CUDA port of the TPU FEM package.

The port of ``pyfem_gpu_testflight_tpu`` to PyTorch on an NVIDIA
Hopper card, slice by slice (ROADMAP.md).  This slice carries the 2D
plane-stress GMG-PCG solve: structured quad4 meshes, RAMP material,
BC-eliminated stencil assembly of every multigrid level (CUDA kernel
K1, ``csrc/assemble_2d.cu``), Chebyshev-node Jacobi smoothing and the
operator matvec (CUDA kernel K2, ``csrc/smooth_2d.cu``), and flexible
PCG.  On CPU tensors each kernel's plain PyTorch version runs instead.

The package imports torch and never jax.  float32 is pinned to IEEE
float32 at import (TF32 off, see ``ops.precision``).
"""

from .ops.precision import pin_fp32 as _pin_fp32

_pin_fp32()

from . import multigrid  # noqa: E402
from .elements import get_element  # noqa: E402
from .mesh import ProblemCreator  # noqa: E402
from .models import LinearElasticity  # noqa: E402

__version__ = "0.1.0"

__all__ = ["LinearElasticity", "ProblemCreator", "get_element", "multigrid"]
