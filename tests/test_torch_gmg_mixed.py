"""PyTorch port, the GMG-PCG slice in the working precision (CPU).

The ``__graft_entry__.entry`` configuration (65x33, p=3, rho=0.6, tip
load, rtol 1e-6) in float32 with the bench's bf16 smoother copy and
flexible PCG, against the JAX package (XLA path under ``jax.jit``):

* the port takes the JAX iteration count within one;
* the two solutions agree to 1e-3 relative (max norm), and the port's
  solution is no further than twice the JAX one's from the float64
  solution of the same problem.

Why 1e-3 and not tighter: this operator is ill-conditioned enough that
float32 rounding of the tables and sums alone puts each float32 solve
about 1.1e-3 (JAX) and 1.4e-3 (port) from the float64 solution on this
CPU, so two correct float32 implementations that sum in different
orders agree only to a few 1e-4 (3.7e-4 measured).  Kept apart from
test_torch_gmg.py so each file's JAX compile stays inside its time
budget.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.dia import interleave_to_planar as j_i2p

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"


def test_entry_config_bf16_flexible_matches_jax():
    nx, ny, rtol = 65, 33, 1e-6
    c = fem.ProblemCreator(nnodes_x=nx, nnodes_y=ny, element_type="quad")
    conn, X, dof_fixed, nodal_force = c.create_linear_elasticity_problem()
    m = fem.LinearElasticity("quad4", X, conn, dof_fixed, None, nodal_force,
                             p=3.0, dtype=jnp.float32)
    Lx, Ly = float(X[:, 0].max()), float(X[:, 1].max())
    rhs = np.array(m.compute_rhs(), np.float32)
    ja = jmg.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=3.0,
                          dtype=jnp.float32, smoother_dtype=jnp.bfloat16)

    @jax.jit
    def forward(rho, rhs):
        gmg, lv0 = ja.assemble(rho)
        b = jnp.where(lv0.mask, 0.0, j_i2p(rhs, 2).reshape(2, ny, nx))
        return jmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100,
                           flexible=True)

    x_ref, k_ref, _ = forward(jnp.full((nx * ny,), 0.6, jnp.float32),
                              jnp.asarray(rhs))
    x_ref, k_ref = np.asarray(x_ref), int(k_ref)

    ta = tmg.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=3.0,
                          dtype=torch.float32, smoother_dtype=torch.bfloat16,
                          device=DEV)
    gmg, lv0 = ta.assemble(torch.full((nx * ny,), 0.6))
    assert lv0.coeff_lp.dtype == torch.bfloat16
    b = torch.where(lv0.mask, 0.0, interleave_to_planar(
        torch.as_tensor(rhs), 2).reshape(2, ny, nx))
    x, k, rn = tmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100,
                           flexible=True)
    assert abs(k - k_ref) <= 1
    assert float(rn) <= rtol * float(torch.linalg.norm(b))
    scale = np.abs(x_ref).max()
    assert np.abs(x.numpy() - x_ref).max() <= 1e-3 * scale

    a64 = tmg.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=3.0,
                           dtype=torch.float64, device=DEV)
    g64, l64 = a64.assemble(torch.full((nx * ny,), 0.6, dtype=torch.float64))
    x64, _, _ = tmg.pcg_gmg(g64, l64, b.double(), rtol=1e-12, maxiter=100)
    x64 = x64.numpy()
    err_port = np.abs(x.numpy() - x64).max()
    err_jax = np.abs(x_ref - x64).max()
    assert err_port <= 2.0 * err_jax
