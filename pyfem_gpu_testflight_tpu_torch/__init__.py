"""pyfem_gpu_testflight_tpu_torch — PyTorch/CUDA port of the TPU FEM package.

The port of ``pyfem_gpu_testflight_tpu`` to PyTorch on an NVIDIA
Hopper card, slice by slice (ROADMAP.md): the 2D and 3D structured
GMG-PCG solves (CUDA kernels K1-K6, ``csrc/``), and the general-mesh
element path of ``LinearElasticity`` / ``LinearPoisson`` — element
stiffness by the einsum path or kernels K7 / K8, a matrix-free
Dirichlet-constrained operator, Jacobi-PCG or a host scipy direct solve
(``solve(method="cg" | "direct")``), and 2D topology optimization — the
compliance functionals and sensitivities, the ``Helmholtz`` density
filter (kernel K9 on structured grids), MMA (``opt``) and the
device-resident ``opt.DeviceTopo`` loop.  On CPU tensors each kernel's
plain PyTorch version runs instead.

The package imports torch and never jax.  float32 is pinned to IEEE
float32 at import (TF32 off, see ``ops.precision``).
"""

from .ops.precision import pin_fp32 as _pin_fp32

_pin_fp32()

from . import multigrid, opt  # noqa: E402
from .elements import get_element  # noqa: E402
from .io.vtk import to_vtk  # noqa: E402
from .mesh import ProblemCreator  # noqa: E402
from .models import Helmholtz, LinearElasticity, LinearPoisson  # noqa: E402

__version__ = "0.1.0"

__all__ = ["Helmholtz", "LinearElasticity", "LinearPoisson",
           "ProblemCreator", "get_element", "multigrid", "opt", "to_vtk"]
