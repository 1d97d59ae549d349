"""PyTorch port, kernel K9 (``ops/stencil_matvec.py``) on CPU.

K9 replaces the Pallas ``stencil_matvec_2d``
(``pyfem_gpu_testflight_tpu/ops/pallas_stencil.py``): y = A u for the
9-point, nd-component stencil with zero padding.  On a CPU tensor the
wrapper runs the plain version, the shifted-slice body of
``Stencil2D.matvec``.  Gated in float64 to 1e-13 relative against the
JAX Pallas kernel in interpret mode (once, at 17x9) and against the JAX
``Stencil2D.matvec`` (nd=1 and nd=2, random planes and a
Helmholtz-filter operator).  The kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu.ops.stencil import Stencil2D as JStencil2D

from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

import torch_threads  # noqa: F401  (one torch thread per worker)

TOL = 1e-13


def _inputs(nd, ny, nx, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nd, nd, 3, 3, ny, nx)),
            rng.standard_normal((nd, ny, nx)))


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_plain_matches_jax_pallas_interpret_17x9():
    from pyfem_gpu_testflight_tpu.ops.pallas_stencil import stencil_matvec_2d

    c, u = _inputs(2, 9, 17, seed=0)
    ref = stencil_matvec_2d(jnp.asarray(c), jnp.asarray(u), ty=8,
                            interpret=True)
    got = sm.stencil_matvec_2d(torch.as_tensor(c), torch.as_tensor(u))
    assert got.dtype == torch.float64
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", [(17, 33), (9, 17), (7, 13)])
def test_plain_matches_jax_stencil_matvec(nd, shape):
    ny, nx = shape
    c, u = _inputs(nd, ny, nx, seed=nd)
    ref = JStencil2D(nx, ny, nd).matvec(jnp.asarray(c), jnp.asarray(u))
    got = sm.stencil_matvec_2d(torch.as_tensor(c), torch.as_tensor(u))
    assert _rel(got, ref) <= TOL
    assert torch.equal(got, sm.stencil_matvec_2d_plain(torch.as_tensor(c),
                                                       torch.as_tensor(u)))


def test_plain_matches_jax_on_a_filter_operator():
    """The Helmholtz filter's K planes (nd=1), the product K9 runs in
    every filter PCG iteration."""
    import pyfem_gpu_testflight_tpu as fem
    import pyfem_gpu_testflight_tpu_torch as pt

    nx, ny = 33, 17
    conn, X, _f, _l = fem.ProblemCreator(
        nnodes_x=nx, nnodes_y=ny).create_linear_elasticity_problem()
    jf = fem.Helmholtz(0.05, "quad4", X, conn).attach_structured_grid(nx, ny)
    pf = pt.Helmholtz(0.05, "quad4", X, conn, dtype=torch.float64,
                      device="cpu").attach_structured_grid(nx, ny)
    assert _rel(pf._coeffK, jf._coeffK) <= TOL
    u = np.random.default_rng(7).standard_normal((1, ny, nx))
    ref = jf._st.matvec(jf._coeffK, jnp.asarray(u))
    got = sm.stencil_matvec_2d(pf._coeffK, torch.as_tensor(u))
    assert _rel(got, ref) <= TOL


def test_wrapper_checks_inputs():
    c, u = _inputs(2, 9, 17, seed=1)
    c, u = torch.as_tensor(c), torch.as_tensor(u)
    with pytest.raises(ValueError):
        sm.stencil_matvec_2d(c[:, :, :, :, :8], u)
    with pytest.raises(ValueError):
        sm.stencil_matvec_2d(c.float(), u)
    with pytest.raises(ValueError):
        sm.stencil_matvec_2d(c, u[0])
