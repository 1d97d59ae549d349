"""PyTorch port, the 3D stencil reference and transfers on CPU (float64).

Gates, against the JAX package:
* ``Stencil3D`` (the plain reference of K3, K4 and K5) method by method
  — plan, ``assemble_uniform``, ``matvec``, ``bc_matvec``,
  ``bc_eliminate``, ``diagonal`` — on a non-cubic 5x4x3 grid, nd=3 and
  nd=1, to 1e-12 relative;
* ``restrict3d_il`` / ``prolong3d_il`` and the per-axis steps to 1e-14,
  and R = P^T (adjointness) to 1e-13;
* ``sym_planes_3d`` and ``halo_sweeps_3d`` equal, the kept planes
  rebuild the full stencil (``full_planes_3d``);
* the 3D hierarchy helpers: ``_grid_sizes_3d``, ``_left_face_mask``,
  ``_restrict_nodal``.

The JAX side runs eagerly (``jax.disable_jit``): at these sizes that is
cheaper than compiling the 243-plane programs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops import pallas_smooth as jps

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
from pyfem_gpu_testflight_tpu_torch.ops.stencil import Stencil3D

import torch_threads  # noqa: F401  (one torch thread per worker)

NX, NY, NZ = 5, 4, 3


def _close(got, want, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_stencil3d_matches_jax(physics):
    ja = jmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.5, 1.0, physics, p=3.0,
                            dtype=jnp.float64)
    jop, _xe, _conn, jmask, _shape, Kq, _pal, _otf = ja.static_levels[0]
    nd = ja.nd
    rng = np.random.default_rng(11)
    rho = rng.uniform(0.2, 1.0, (NZ, NY, NX))
    u = rng.standard_normal((nd, NZ, NY, NX))
    with jax.disable_jit():
        Cq = ja.material_planes(jnp.asarray(rho))
        coeff = jop.assemble_uniform(Cq, Kq)
        ce = jop.bc_eliminate(coeff, jmask)
        ref = [np.asarray(a) for a in (
            coeff, ce, jop.diagonal(ce), jop.matvec(coeff, jnp.asarray(u)),
            jop.bc_matvec(coeff, jmask, jnp.asarray(u)),
        )]
    op = Stencil3D(NX, NY, NZ, nd)
    assert op.plan == jop.plan
    mask = torch.as_tensor(np.asarray(jmask))
    ut = torch.as_tensor(u)
    c = op.assemble_uniform(torch.as_tensor(np.asarray(Cq)), np.asarray(Kq))
    cet = op.bc_eliminate(c, mask)
    _close(c, ref[0])
    _close(cet, ref[1])
    _close(op.diagonal(cet), ref[2])
    _close(op.matvec(c, ut), ref[3])
    _close(op.bc_matvec(c, mask, ut), ref[4])
    # elimination is what bc_matvec does, folded into the planes
    _close(op.matvec(cet, ut), ref[4])
    # the kept planes rebuild the eliminated stencil (it is symmetric)
    keep = [k for (k, *_r) in fs.sym_planes_3d(nd)]
    kept = cet.reshape(nd * nd * 27, NZ, NY, NX)[keep]
    _close(fs.full_planes_3d(kept, nd), ref[1])


@pytest.mark.parametrize("nd", [1, 3])
def test_sym_planes_and_budget_match_jax(nd):
    assert fs.sym_planes_3d(nd) == jps.sym_planes_3d(nd)
    assert len(fs.sym_planes_3d(nd)) == {1: 14, 3: 123}[nd]
    for niter in range(1, 5):
        for x0_zero in (False, True):
            for want_resid in (False, True):
                assert fs.halo_sweeps_3d(niter, x0_zero, want_resid) == (
                    jps.halo_sweeps_3d(niter, x0_zero, want_resid))


@pytest.mark.parametrize("fine", [(9, 5, 5), (5, 9, 17), (3, 3, 3)])
def test_transfers3d_match_jax(fine):
    coarse = tuple((n + 1) // 2 for n in fine)
    rng = np.random.default_rng(sum(fine))
    f = rng.standard_normal((3,) + fine)
    c = rng.standard_normal((3,) + coarse)
    ft, ct = torch.as_tensor(f), torch.as_tensor(c)
    with jax.disable_jit():
        r_ref = jmg.restrict3d_il(jnp.asarray(f), coarse)
        p_ref = jmg.prolong3d_il(jnp.asarray(c), fine)
        ra_ref = jmg.restrict_axis_il(jnp.asarray(f), 2, coarse[1])
        pa_ref = jmg.prolong_axis_il(jnp.asarray(c), 3, fine[2])
    _close(tmg.restrict3d_il(ft, coarse), r_ref, 1e-14)
    _close(tmg.prolong3d_il(ct, fine), p_ref, 1e-14)
    _close(tmg.restrict_axis_il(ft, 2, coarse[1]), ra_ref, 1e-14)
    _close(tmg.prolong_axis_il(ct, 3, fine[2]), pa_ref, 1e-14)
    # R = P^T: <R f, c> = <f, P c>
    lhs = float((tmg.restrict3d_il(ft, coarse) * ct).sum())
    rhs = float((ft * tmg.prolong3d_il(ct, fine)).sum())
    assert abs(lhs - rhs) <= 1e-13 * abs(lhs)


def test_hierarchy_helpers_match_jax():
    for args in ((65, 65, 65), (9, 7, 5), (17, 9, 33), (4, 5, 5)):
        assert tmg._grid_sizes_3d(*args) == jmg._grid_sizes_3d(*args)
        assert tmg._grid_sizes_3d(*args, min_n=5) == jmg._grid_sizes_3d(
            *args, min_n=5)
    assert np.array_equal(tmg._left_face_mask(5, 4, 3, 3),
                          jmg._left_face_mask(5, 4, 3, 3))
    g = np.random.default_rng(3).standard_normal((9, 7, 5))
    with jax.disable_jit():
        ref = np.asarray(jmg._restrict_nodal(jnp.asarray(g)))
    assert np.array_equal(tmg._restrict_nodal(torch.as_tensor(g)).numpy(),
                          ref)
