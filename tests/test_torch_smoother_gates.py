"""PyTorch port held to the JAX package's Chebyshev-node smoothing gates.

Twins of ``tests/test_cheby_smooth.py`` on CPU (the kernels' plain
versions), on the JAX tests' problems (left-clamped plane stress and
hex8 elasticity, p = 0, rho = 1, float32, rtol 1e-6, maxiter 60):

* ``smoothing_omegas``: reciprocals of nodes in [lam/frac, 1.02 lam],
  ordered small to large, the stationary degenerate case;
* ``omega="cheby"`` takes fewer PCG iterations than the tuned
  stationary omega (2D 33^2: fewer; 3D 17^3: no more), and the port's
  two forms of the same V-cycle agree, as the JAX gate holds its XLA and
  Pallas paths: in 2D ``pcg_gmg`` (A z riding the fine postsmooth, one
  K2 call a smoothing call) against ``pcg`` with the level's matvec (the
  same iterations), in 3D K5's one-call smoothing against per-sweep K4
  passes (iterations within 1); solutions within 1e-4 of each other.
  The JAX references are not run here: they compile for 28 s (2D) and
  64 s (3D) on one core;
* tuple-omega smoothing equals hand-rolled nonstationary sweeps in
  float64 (1e-14), and post-smoothing takes the reversed factors.

The sharded gate (``:141``) is a case of ``tests/test_torch_sharded_gmg
.py``, on the ranks that file spawns.
"""

import numpy as np
import pytest
import torch

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import multigrid
from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar

import torch_threads  # noqa: F401  (one torch thread per worker)

DEV = "cpu"


def _setup(dims, omega, dtype=torch.float32):
    et = "quad" if len(dims) == 2 else "block"
    c = pt.ProblemCreator(*dims, element_type=et)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4" if len(dims) == 2 else "hex8", X, conn,
                            fixed, None, force, p=0.0, dtype=dtype,
                            device=DEV)
    L = [float(X[:, k].max()) for k in range(len(dims))]
    cls = multigrid.GMGAssembler if len(dims) == 2 else \
        multigrid.GMGAssembler3D
    asm = cls(*dims, *L, "elasticity", p=0.0, dtype=dtype, device=DEV,
              omega=omega)
    gmg, lv0 = asm.assemble(torch.ones(m.nnodes, dtype=dtype))
    nd = len(dims)
    b = torch.where(lv0.mask, 0.0, interleave_to_planar(
        m.compute_rhs(), nd).reshape((nd,) + tuple(dims[::-1])))
    return gmg, lv0, b


def _solve(dims, omega, form="kernel"):
    gmg, lv0, b = _setup(dims, omega)
    if form == "plain" and len(dims) == 2:
        x, k, _ = multigrid.pcg(lv0.matvec, gmg.apply, b, rtol=1e-6,
                                maxiter=60)
    else:
        if form == "plain":  # per-sweep K4 passes in place of K5 calls
            for lv in gmg.levels[:-1]:
                lv.can_fuse3d = lambda *a: False
        x, k, _ = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=60)
    return x.numpy(), k


def test_smoothing_omegas_nodes():
    oms = multigrid.smoothing_omegas(2, lam_max=3.0, frac=8.0)
    assert len(oms) == 2
    for w in oms:
        assert 1.0 / (1.02 * 3.0) <= w <= 8.0 / 3.0
    assert oms[0] < oms[1]
    assert multigrid.smoothing_omegas(1, 3.0, 8.0)[0] == pytest.approx(
        1.0 / (0.5 * (3.0 / 8.0 + 1.02 * 3.0)), rel=1e-12)


@pytest.mark.parametrize("dims,omega_jac", [((33, 33), 0.7),
                                            ((17, 17, 17), 0.6)],
                         ids=["2d", "3d"])
def test_cheby_fewer_iters_both_forms(dims, omega_jac):
    _x, k_jac = _solve(dims, omega_jac)
    x_k, k_k = _solve(dims, "cheby")
    x_p, k_p = _solve(dims, "cheby", form="plain")
    if len(dims) == 2:
        assert k_k < k_jac and k_p == k_k, (k_jac, k_k, k_p)
    else:
        assert k_k <= k_jac and abs(k_p - k_k) <= 1, (k_jac, k_k, k_p)
    assert np.abs(x_p - x_k).max() / np.abs(x_k).max() < 1e-4


def test_omega_tuple_matches_explicit_sweeps_f64():
    """One presmoothing call with omega=(w1, w2) against explicit sweeps:
    x1 = w1 D^-1 b; x2 = x1 + w2 D^-1 (b - A x1)."""
    oms = (0.4, 1.1)
    gmg, lv, b = _setup((17, 17), oms, dtype=torch.float64)
    got, _r = lv.presmooth_resid(b, 2, gmg._omegas(2))
    x1 = oms[0] * lv.inv_diag * torch.where(lv.mask, 0.0, b)
    r = b - lv.matvec(x1)
    want = x1 + oms[1] * lv.inv_diag * torch.where(lv.mask, 0.0, r)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-14)
    assert gmg._omegas(2) == oms
    assert gmg._omegas(2, reverse=True) == tuple(reversed(oms))
