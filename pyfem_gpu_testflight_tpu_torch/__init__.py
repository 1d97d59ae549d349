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
device-resident ``opt.DeviceTopo`` loop — and the Newton-solved
``NonlinearPoisson`` model: restarted GMRES (``solvers.gmres``) and
``solvers.newton``, with GMRES on the exact tangent stencil (K9)
right-preconditioned by a V-cycle (K1 levels, K2 smoothing) on
structured grids — and the two-level p-multigrid of tet10/brick20
lattices (``pmg``, ``attach_pmg`` / ``solve(method="pmg")``) — and
unstructured meshes: the Abaqus ``.inp`` reader (``InpParser``), the
native host set-up (``native``), the DIA operator (``ops.dia``, kernel
U2) and smoothed-aggregation AMG-PCG on CSR levels (``unstructured``,
kernel U1; ``solve(method="amg")``) — and the user-facing surface:
strain/stress recovery, mass matrices, natural frequencies (host eigsh
and a matrix-free device LOBPCG), KS aggregation and adjoint solves
(``postprocess``), the reference-style ``compat`` layer, the
``Assembler`` facade and the ``time_this`` / ``timer_*`` call-graph
profiler (``utils.profile``), with the reference's example scripts in
``examples``.  On CPU tensors each kernel's plain PyTorch version runs
instead.

The package imports torch and never jax.  float32 is pinned to IEEE
float32 at import (TF32 off, see ``ops.precision``).
"""

from .ops.precision import pin_fp32 as _pin_fp32

_pin_fp32()

from . import assembly, bcs, elements, mesh, multigrid, opt, pmg, solvers  # noqa: E402,E501
from .bcs import DirichletBC  # noqa: E402
from .elements import ElementType, get_element  # noqa: E402
from .io.vtk import to_vtk  # noqa: E402
from .io.inp import InpParser  # noqa: E402
from .mesh import ProblemCreator, fix_orientation, structured_mesh  # noqa: E402,E501
from .models import (  # noqa: E402
    FEModel, Helmholtz, LinearElasticity, LinearPoisson, NonlinearPoisson,
    NonlinearPoisson2D,
)
from .assembler import Assembler  # noqa: E402
from .utils.profile import (  # noqa: E402
    time_this,
    timer_off,
    timer_on,
    timer_set_threshold,
    timer_to_stdout,
)

__version__ = "0.1.0"

# The JAX package's exports, plus the port's own multigrid, opt, pmg and
# NonlinearPoisson2D.
__all__ = [
    "fix_orientation",
    "Assembler",
    "DirichletBC",
    "ElementType",
    "FEModel",
    "Helmholtz",
    "InpParser",
    "LinearElasticity",
    "LinearPoisson",
    "NonlinearPoisson",
    "NonlinearPoisson2D",
    "ProblemCreator",
    "assembly",
    "bcs",
    "elements",
    "get_element",
    "mesh",
    "multigrid",
    "opt",
    "pmg",
    "solvers",
    "structured_mesh",
    "time_this",
    "timer_off",
    "timer_on",
    "timer_set_threshold",
    "timer_to_stdout",
    "to_vtk",
]
