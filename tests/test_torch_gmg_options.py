"""PyTorch port, the GMG options and the top-level exports on CPU (float64).

Gates, against the JAX package:

* every exported transfer — ``restrict2d``/``prolong2d``,
  ``restrict3d``/``prolong3d`` and their convolution forms — equals the
  JAX one within 1e-13 (relative), is the exact adjoint of its partner
  and the same operator as the interleave form;
* one ``GMG(smoother="chebyshev")`` V-cycle, 2D 17x9 elasticity (the
  coarsest level smoothed, no dense inverse) and 3D 9^3 Poisson (dense
  coarsest), equals the JAX ``GMG`` on the same levels (the port's
  planes handed to JAX ``Level``s) within 1e-10;
* the convolution transfers passed as ``restrict_fn`` / ``prolong_fn``
  give the default transfers' V-cycle;
* ``GMGAssembler3D(elem_path="otf", smoother="chebyshev")`` (K6 residual
  passes) gives the assembled levels' Chebyshev V-cycle, and
  ``attach_structured_grid(..., smoother="chebyshev")`` solves to the
  direct solution;
* ``build_elasticity_gmg`` / ``build_poisson_gmg`` + ``pcg`` take the
  JAX package's iterations, the solution within 1e-10;
* the top-level ``__all__`` is the JAX package's plus the port's own.

The JAX hierarchies are assembled eagerly (compiling an assembly costs
more than running it at these sizes); the V-cycles and PCG loops are
compiled.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.stencil import (
    Stencil2D as JStencil2D, Stencil3D as JStencil3D,
)

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"
F64 = torch.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_transfers_match_jax(dim):
    fine = (17, 9) if dim == 2 else (9, 5, 7)
    coarse = tuple((n + 1) // 2 for n in fine)
    rng = np.random.default_rng(dim)
    f = rng.standard_normal((2,) + fine)
    c = rng.standard_normal((2,) + coarse)
    tf, tc = torch.as_tensor(f), torch.as_tensor(c)
    d = f"{dim}d"
    r_il = getattr(tmg, f"restrict{d}_il")(tf, coarse).numpy()
    p_il = getattr(tmg, f"prolong{d}_il")(tc, fine).numpy()
    for form in ("", "_conv"):
        r = getattr(tmg, f"restrict{d}{form}")(tf, coarse).numpy()
        p = getattr(tmg, f"prolong{d}{form}")(tc, fine).numpy()
        r_ref = jax.jit(getattr(jmg, f"restrict{d}{form}"),
                        static_argnums=1)(jnp.asarray(f), coarse)
        p_ref = jax.jit(getattr(jmg, f"prolong{d}{form}"),
                        static_argnums=1)(jnp.asarray(c), fine)
        assert _rel(r, r_ref) <= 1e-13 and _rel(p, p_ref) <= 1e-13, form
        assert _rel(r, r_il) <= 1e-13 and _rel(p, p_il) <= 1e-13, form
        # R = P^T: <R f, c> = <f, P c>
        assert abs(np.vdot(r, c) - np.vdot(f, p)) <= 1e-13 * abs(
            np.vdot(f, p))


def _jax_apply(gmg, r):
    """One V-cycle of the JAX ``GMG`` over JAX ``Level``s built from the
    port's planes (the JAX ``Level`` re-eliminates them, which leaves
    them as they are), the coarsest with its dense inverse when the
    port's has one; levels and V-cycle in one compiled call."""
    ops, planes = [], []
    for lv in gmg.levels:
        shape, nd = lv.shape, lv.nd
        if len(shape) == 2:
            ops.append(JStencil2D(shape[1], shape[0], nd))
            full = fused_smooth.as_full_planes_2d(lv.coeff, nd)
        else:
            ops.append(JStencil3D(shape[2], shape[1], shape[0], nd))
            full = fused_smooth.as_full_planes_3d(lv.coeff, nd)
        planes.append(jnp.asarray(full.reshape(
            (nd, nd) + (3,) * len(shape) + shape).numpy()))
    masks = [jnp.asarray(lv.mask.numpy()) for lv in gmg.levels]

    def apply(planes, masks, r):
        levels = [jmg.Level(op, c, m, lv.shape, lv.nd)
                  for op, c, m, lv in zip(ops, planes, masks, gmg.levels)]
        if gmg.levels[-1].dense_inv is not None:
            levels[-1].dense_factor()
        return jmg.GMG(levels, nu_pre=gmg.nu_pre, nu_post=gmg.nu_post,
                       coarse_iters=gmg.coarse_iters, smoother="chebyshev",
                       cheb_lam=gmg.cheb_lam).apply(r)

    return jax.jit(apply)(planes, masks, jnp.asarray(r.numpy()))


def _hierarchy(dim, physics="elasticity", **kw):
    if dim == 2:
        asm = tmg.GMGAssembler(17, 9, 2.0, 1.0, physics, p=3.0,
                               dtype=F64, device=DEV, min_n=5,
                               smoother="chebyshev", **kw)
        n = 17 * 9
    else:
        asm = tmg.GMGAssembler3D(9, 9, 9, 1.0, 1.0, 1.0, physics,
                                 p=3.0, dtype=F64, device=DEV,
                                 smoother="chebyshev", **kw)
        n = 9 ** 3
    rho = torch.as_tensor(0.3 + 0.7 * np.random.default_rng(7).random(n))
    return asm.assemble(rho)


@pytest.mark.parametrize("dim", [2, 3])
def test_chebyshev_vcycle_matches_jax(dim):
    if dim == 2:  # the coarsest level smoothed by the recurrence
        gmg, lv0 = _hierarchy(2, coarse_dense=False)
        gmg = tmg.GMG(gmg.levels, smoother="chebyshev", coarse_iters=4,
                      cheb_lam=gmg.cheb_lam)
    else:
        gmg, lv0 = _hierarchy(3, "poisson")
    assert not gmg.supports_apply_resid
    assert (gmg.levels[-1].dense_inv is None) == (dim == 2)
    r = torch.as_tensor(np.random.default_rng(dim).standard_normal(
        lv0.inv_diag.shape))
    assert _rel(gmg.apply(r).numpy(), _jax_apply(gmg, r)) <= 1e-10


def test_conv_transfers_as_options():
    gmg, lv0 = _hierarchy(3)
    r = torch.as_tensor(np.random.default_rng(1).standard_normal(
        lv0.inv_diag.shape))
    z = gmg.apply(r)
    conv = tmg.GMG(gmg.levels, nu_pre=2, nu_post=2, smoother="chebyshev",
                   cheb_lam=gmg.cheb_lam, restrict_fn=tmg.restrict3d_conv,
                   prolong_fn=tmg.prolong3d_conv)
    assert _rel(conv.apply(r).numpy(), z.numpy()) <= 1e-12


def test_chebyshev_on_the_fly_levels():
    gmg, lv0 = _hierarchy(3)
    gmg_o, lv0_o = _hierarchy(3, elem_path="otf")
    assert type(lv0_o).__name__ == "OTFLevel"
    assert _rel(lv0_o.inv_diag.numpy(), lv0.inv_diag.numpy()) <= 1e-12
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(
        lv0.inv_diag.shape))
    assert _rel(gmg_o.apply(r).numpy(), gmg.apply(r).numpy()) <= 1e-10


def test_model_gmg_chebyshev_solves():
    conn, X, fixed, force = pt.ProblemCreator(
        33, 17).create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                            device=DEV)
    m.attach_structured_grid(33, 17, smoother="chebyshev")
    u = m.solve(method="gmg", rho=0.6, rtol=1e-10)
    assert m.last_solve_stats["iters"] > 0
    u_dir = m.solve(method="direct", rho=0.6)
    assert _rel(u.numpy(), u_dir.numpy()) <= 1e-8
    with pytest.raises(ValueError, match="smoother"):
        tmg.GMG(m._gmg_asm.assemble(torch.ones(m.nnodes, dtype=F64))[0]
                .levels, smoother="sor")


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_build_gmg_matches_jax(physics):
    nx, ny, Lx, Ly = 17, 9, 2.0, 1.0
    nd = 2 if physics == "elasticity" else 1
    build_t = getattr(tmg, f"build_{physics}_gmg")
    build_j = getattr(jmg, f"build_{physics}_gmg")
    gmg, lv0 = build_t(nx, ny, Lx, Ly, p=3.0, dtype=F64, device=DEV,
                       rho=torch.full((nx * ny,), 0.6, dtype=F64))
    b = np.random.default_rng(nd).standard_normal((nd, ny, nx))
    b = torch.where(lv0.mask, 0.0, torch.as_tensor(b))
    x, k, _rn = tmg.pcg(lv0.matvec, gmg.apply, b, rtol=1e-10)
    with jax.disable_jit():
        jg, jlv0 = build_j(nx, ny, Lx, Ly, p=3.0, dtype=jnp.float64,
                           rho=jnp.full((nx * ny,), 0.6))
    x_ref, k_ref, _ = jax.jit(
        lambda b: jmg.pcg(jlv0.matvec, jg.apply, b, rtol=1e-10)
    )(jnp.asarray(b.numpy()))
    assert k == int(k_ref)
    assert _rel(x.numpy(), x_ref) <= 1e-10


def test_exports_match_jax():
    later = set()
    own = {"multigrid", "opt", "pmg", "NonlinearPoisson2D"}
    assert set(pt.__all__) - own == set(fem.__all__) - later
    for name in pt.__all__:
        assert getattr(pt, name) is not None
