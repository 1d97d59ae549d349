"""PyTorch port, the 3D hex8 GMG-PCG slice end to end on CPU (float64).

Gates, against the JAX package (its XLA path, ``pallas_smooth=False``,
run eagerly under ``jax.disable_jit``: compiling the 243-plane
hierarchy costs about a minute, more than running it at these sizes;
only each level's stencil matvec, a thousand eager ops, is compiled on
its own, see :func:`_compiled_matvecs`):

* ``bench.py --config 3d``'s solver settings (Chebyshev-node nu=2,
  rtol 1e-6, coarsest 3^3 solved densely) at 9^3 (rho=1, and p=3 with a
  seeded random rho) and 17^3 (rho=1): the same PCG iteration count (7
  at rho=1), the solutions within 1e-10 relative; the same at 9^3 with
  full (``sym=False``) coefficient storage;
* ``LinearElasticity("hex8").solve(method="gmg")`` equals the JAX
  model's same call (iterations and solution);
* ``convert.assembler_state_from_numpy`` carrying a JAX
  ``GMGAssembler3D``'s tables in gives identical level planes;
* the entry points default to the CUDA card and, with no CUDA present,
  raise unless given ``device="cpu"``;
* the unported element path (``einsum``) raises naming ROADMAP.md.

:func:`solve_both` is shared with ``tests/test_torch_otf3d.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.dia import interleave_to_planar as j_i2p

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import bcs as tbcs
from pyfem_gpu_testflight_tpu_torch import convert
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.device import resolve_device
from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"


_COMPILED = {}


def _compiled_matvecs(ops):
    """Run each JAX ``Stencil3D``'s matvec as one compiled XLA call.

    The same method, compiled ahead of time once per grid and argument
    shape (outside ``disable_jit``), replaces the instance's eager one;
    the V-cycle around it stays eager.  Traced calls (the coarse dense
    factor's ``vmap``) keep the eager method.
    """
    for op in ops:
        if getattr(op, "_eager_matvec", None) is not None:
            continue
        op._eager_matvec = eager = op.matvec

        def matvec(coeff, u, op=op, eager=eager):
            if isinstance(coeff, jax.core.Tracer) or isinstance(
                u, jax.core.Tracer
            ):
                return eager(coeff, u)
            key = (op.nx, op.ny, op.nz, op.nd, coeff.shape, coeff.dtype,
                   u.shape, u.dtype)
            with jax.disable_jit(False):
                if key not in _COMPILED:
                    _COMPILED[key] = jax.jit(eager).lower(coeff, u).compile()
                return _COMPILED[key](coeff, u)

        op.matvec = matvec


def _problem(n):
    c = fem.ProblemCreator(n, n, n, element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return conn, X, fixed, force, [float(X[:, k].max()) for k in range(3)]


_JAX_SOLVES = {}


def _jax_solve(n, p, rho, rhs, rtol):
    """The JAX package's assembled XLA route, once per problem in this
    process: ((x, iters), level shapes)."""
    key = (n, p, rho.tobytes(), rtol)
    if key not in _JAX_SOLVES:
        L = _problem(n)[4]
        ja = jmg.GMGAssembler3D(n, n, n, *L, "elasticity", dtype=jnp.float64,
                                p=p, nu_pre=2, nu_post=2, min_n=3,
                                coarse_dense_max=4096, omega="cheby")
        _compiled_matvecs(st[0] for st in ja.static_levels)
        with jax.disable_jit():
            gmg, lv0 = ja.assemble(jnp.asarray(rho))
            b = jnp.where(lv0.mask, 0.0, j_i2p(jnp.asarray(rhs), 3).reshape(
                3, n, n, n))
            x, k, _ = jmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100)
        _JAX_SOLVES[key] = ((np.asarray(x), int(k)),
                            [lv.shape for lv in gmg.levels])
    return _JAX_SOLVES[key]


def solve_both(n, p, rho, rtol=1e-6, **port_kw):
    """The bench 3D solver settings in both packages, float64.

    ``port_kw`` (``elem_path``, ``sym``) picks the port's route; the JAX
    side is always its assembled XLA route (solved once per problem).

    Returns ((x, iters) JAX, (x, iters, resnorm, ||b||) port).
    """
    conn, X, fixed, force, L = _problem(n)
    m = fem.LinearElasticity("hex8", X, conn, fixed, None, force, p=p)
    rhs = np.asarray(m.compute_rhs())
    ref, shapes = _jax_solve(n, p, rho, rhs, rtol)
    ta = tmg.GMGAssembler3D(n, n, n, *L, "elasticity", dtype=torch.float64,
                            device=DEV, p=p, nu_pre=2, nu_post=2, min_n=3,
                            coarse_dense_max=4096, omega="cheby", **port_kw)
    tg, tl0 = ta.assemble(torch.as_tensor(rho))
    assert [lv.shape for lv in tg.levels] == shapes
    assert tg.levels[-1].dense_inv is not None
    assert not tg.supports_apply_resid  # 3D: pcg with the K4 / K6 matvec
    bt = torch.where(tl0.mask, 0.0, interleave_to_planar(
        torch.as_tensor(rhs), 3).reshape(3, n, n, n))
    xt, kt, rn = tmg.pcg_gmg(tg, tl0, bt, rtol=rtol, maxiter=100)
    return ref, (xt.numpy(), kt, float(rn), float(torch.linalg.norm(bt)))


@pytest.mark.parametrize("n,case", [(9, "rho=1"), (9, "p=3 random rho"),
                                    (17, "rho=1")])
def test_bench3d_solver_matches_jax(n, case):
    rtol = 1e-6
    if case == "rho=1":
        p, rho = 0.0, np.ones(n ** 3)
    else:
        p, rho = 3.0, np.random.default_rng(2).uniform(0.3, 1.0, n ** 3)
    (x_ref, k_ref), (x, k, rn, bn) = solve_both(n, p, rho, rtol)
    if case == "rho=1":
        assert k_ref == 7
    assert k == k_ref
    assert rn <= rtol * bn
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


def test_bench3d_full_storage_matches_jax():
    """sym=False: K3 writes all 243 planes, K4/K5 read them."""
    n, rtol = 9, 1e-6
    (x_ref, k_ref), (x, k, rn, bn) = solve_both(n, 0.0, np.ones(n ** 3), rtol,
                                                sym=False)
    assert k_ref == 7 and k == k_ref
    assert rn <= rtol * bn
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


def test_model_entry_matches_jax():
    n = 5
    conn, X, fixed, force, _L = _problem(n)
    rho = np.random.default_rng(7).uniform(0.3, 1.0, n ** 3)
    jm = fem.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0)
    jm.attach_structured_grid(n, n, n)
    _compiled_matvecs(st[0] for st in jm._gmg_asm.static_levels)
    with jax.disable_jit():
        u_ref = np.asarray(jm.solve(method="gmg", rho=rho, rtol=1e-10))
    tm = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                             dtype=torch.float64, device=DEV)
    tm.attach_structured_grid(n, n, n)
    u = tm.solve(method="gmg", rho=rho, rtol=1e-10)
    assert u.shape == (3 * n ** 3,)
    assert tm.last_solve_stats["iters"] > 0
    assert np.abs(u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()
    with pytest.raises(ValueError, match="quad4"):
        tm.attach_structured_grid(n, n * n)  # 2D gmg needs a quad4 model


def test_convert_installs_jax_3d_tables():
    n = 9
    L = (2.0, 1.0, 1.0)
    ja = jmg.GMGAssembler3D(n, n, n, *L, "elasticity", p=3.0,
                            dtype=jnp.float32)
    ta = tmg.GMGAssembler3D(n, n, n, *L, "elasticity", p=3.0,
                            dtype=torch.float32, device=DEV)
    rho = torch.as_tensor(np.random.default_rng(4).uniform(0.3, 1.0, n ** 3),
                          dtype=torch.float32)
    own, _ = ta.assemble(rho)
    Kq = [np.asarray(st[5]) for st in ja.static_levels]
    masks = [np.asarray(st[3]) for st in ja.static_levels]
    convert.assembler_state_from_numpy(ta, Kq, masks)
    got, _ = ta.assemble(rho)
    for a, b in zip(own.levels, got.levels):
        assert torch.equal(a.coeff, b.coeff)
        assert torch.equal(a.inv_diag, b.inv_diag)
        assert torch.equal(a.mask, b.mask)
    for st, K in zip(ta.static_levels, Kq):
        assert np.array_equal(st.Kq.numpy(), K)
    with pytest.raises(ValueError):
        convert.assembler_state_from_numpy(ta, Kq[:1], masks[:1])


def test_default_device_is_the_card(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = pt.ProblemCreator(5, 5, 5, element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    for make in (
        lambda: resolve_device(None),
        lambda: tmg.GMGAssembler3D(5, 5, 5, 1.0, 1.0, 1.0),
        lambda: tmg.GMGAssembler(9, 5, 2.0, 1.0),
        lambda: pt.LinearElasticity("hex8", X, conn, fixed, None, force),
        lambda: tbcs.DirichletBC([0, 1], None, 4),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_unported_3d_paths_raise():
    # the einsum route is ported: it builds (and solves, see
    # tests/test_torch_topo3d.py)
    a = tmg.GMGAssembler3D(5, 5, 5, 1.0, 1.0, 1.0, elem_path="einsum",
                           device=DEV)
    assert all(st.elem is not None for st in a.static_levels)
    # the on-the-fly route is ported: it builds (and solves, see
    # tests/test_torch_otf3d.py)
    a = tmg.GMGAssembler3D(5, 5, 5, 1.0, 1.0, 1.0, elem_path="otf",
                           device=DEV)
    assert a.static_levels[0].otf is not None
    with pytest.raises(ValueError):
        tmg.GMGAssembler3D(5, 5, 5, 1.0, 1.0, 1.0, elem_path="pallas",
                           device=DEV)
