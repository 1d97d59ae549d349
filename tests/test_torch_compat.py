"""PyTorch port: the reference-style compat layer and ``Assembler`` on
CPU, against the JAX package's compat outputs (float64).

The four reference-style scripts of tests/test_compat.py (linear
Poisson by ``Assembler.solve(method="direct")``, also held against the
NumPy oracle; elasticity with the ``_compute_K_dv_sens`` hook against a
complex step; the Helmholtz filter and the quadrature/basis objects;
nonlinear Poisson by ``Assembler.solve_nonlinear``) give the JAX compat
results within 1e-10; the ``utils.py``-style free functions give the
JAX ones on the same arrays; ``Assembler.solve`` on ``cg`` and
``solve_nonlinear`` match JAX, and ``Assembler.plot`` draws under
matplotlib's Agg backend.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import torch_threads  # noqa: F401  (one torch thread per worker)
import pyfem_gpu_testflight_tpu.compat as jpyfem
import pyfem_gpu_testflight_tpu_torch.compat as pyfem
from oracles.poisson_oracle import solve_poisson

DEV = "cpu"


def gfunc(x):
    _x, _y = x[..., 0], x[..., 1]
    return _x * (_x - 5.0) * (_x - 10.0) * _y * (_y - 4.0)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _script(mod, name, **dev):
    """One reference-style script on ``mod`` (the port's or the JAX
    compat module): returns its outputs as host arrays."""
    if name == "poisson":
        creator = mod.ProblemCreator(nnodes_x=32, nnodes_y=32)
        conn, X, dof_fixed = creator.create_poisson_problem()
        quadrature = mod.QuadratureBilinear2D()
        basis = mod.BasisBilinear2D(quadrature)
        model = mod.LinearPoisson(X, conn, dof_fixed, None, quadrature,
                                  basis, gfunc, **dev)
        u = mod.Assembler(model).solve(method="direct")
        return {"u": u, "mesh": (conn, X, dof_fixed)}
    if name == "elasticity":
        creator = mod.ProblemCreator(nnodes_x=16, nnodes_y=16,
                                     element_type="quad")
        conn, X, dof_fixed, nodal_force = (
            creator.create_linear_elasticity_problem())
        quadrature = mod.QuadratureBilinear2D()
        basis = mod.BasisBilinear2D(quadrature)
        model = mod.LinearElasticity(X, conn, dof_fixed, None, nodal_force,
                                     quadrature, basis, p=5.0, **dev)
        rng = np.random.RandomState(0)
        phi, psi = rng.rand(model.ndof), rng.rand(model.ndof)
        rho, pvec = rng.rand(model.nnodes), rng.rand(model.nnodes)
        h = 1e-30
        K = model.compute_jacobian(rho + 1j * h * pvec)
        return {"sens": model._compute_K_dv_sens(rho, phi, psi),
                "cs": phi.dot(K.dot(psi)).imag / h, "pvec": pvec,
                "u": mod.Assembler(model).solve(method="cg", rtol=1e-12)}
    if name == "helmholtz":
        creator = mod.ProblemCreator(nnodes_x=16, nnodes_y=16,
                                     element_type="quad")
        conn, X, x = creator.create_helmhotz_problem()  # reference spelling
        quadrature = mod.QuadratureBilinear2D()
        basis = mod.BasisBilinear2D(quadrature)
        model = mod.Helmholtz(0.1, X, conn, quadrature, basis, **dev)
        return {"rho": model.apply(x), "x": x, "q": quadrature, "b": basis}
    creator = mod.ProblemCreator(nnodes_x=12, nnodes_y=12)
    conn, X, dof_fixed = creator.create_poisson_problem()
    quadrature = mod.QuadratureBilinear2D()
    basis = mod.BasisBilinear2D(quadrature)
    model = mod.NonlinearPoisson2D(X, conn, dof_fixed, None, quadrature,
                                   basis, **dev)
    u = mod.Assembler(model).solve_nonlinear(method="gmres",
                                             xdv=np.ones(10) / 10)
    return {"u": u, "model": model}


def _host(v):
    return v.numpy() if hasattr(v, "numpy") and not isinstance(
        v, np.ndarray) else np.asarray(v)


@pytest.mark.parametrize("name",
                         ["poisson", "elasticity", "helmholtz", "nonlinear"])
def test_reference_style_script_matches_jax(name):
    got = _script(pyfem, name, device=DEV)
    ref = _script(jpyfem, name)
    if name == "poisson":
        u = _host(got["u"])
        assert _rel(u, ref["u"]) <= 1e-10
        u_ref = solve_poisson(*got["mesh"], gfunc)
        p = np.random.RandomState(123).rand(u.shape[0])
        assert abs((p @ u - p @ u_ref) / (p @ u)) < 1e-10
    elif name == "elasticity":
        assert isinstance(got["sens"], np.ndarray)
        assert _rel(got["sens"], ref["sens"]) <= 1e-12
        dfdrho = got["pvec"] @ got["sens"]
        assert abs((dfdrho - got["cs"]) / dfdrho) < 1e-12
        assert _rel(_host(got["u"]), ref["u"]) <= 1e-10
    elif name == "helmholtz":
        rho = _host(got["rho"])
        assert rho.shape == got["x"].shape
        assert _rel(rho, ref["rho"]) <= 1e-10
        q, b = got["q"], got["b"]
        assert q.get_nquads() == 4 and q.get_pt().shape == (4, 2)
        assert q.get_weight().shape == (4,)
        assert b.eval_shape_fun().shape == (4, 4)
        assert b.eval_shape_fun_deriv().shape == (4, 4, 2)
        np.testing.assert_array_equal(q.get_pt(), ref["q"].get_pt())
        with pytest.raises(ValueError):
            pyfem.BasisBlock3D(q)
    else:
        u = _host(got["u"])
        assert np.isfinite(u).all() and np.abs(u).max() > 0
        assert _rel(u, ref["u"]) <= 1e-10
        K, rhs = got["model"].apply_dirichlet_bcs(
            got["model"].compute_jacobian(np.ones(10) / 10, u),
            np.ones(got["model"].ndof))
        Kj, rhsj = ref["model"].apply_dirichlet_bcs(
            ref["model"].compute_jacobian(jnp.ones(10) / 10,
                                          jnp.asarray(u)),
            np.ones(got["model"].ndof))
        assert _rel(K.toarray(), Kj.toarray()) <= 1e-12
        np.testing.assert_array_equal(rhs, rhsj)


def test_utils_surface_matches_jax():
    """Reference utils.py-style out-arg helpers on NumPy arrays."""
    import pyfem_gpu_testflight_tpu_torch as pt

    creator = pyfem.ProblemCreator(nnodes_x=5, nnodes_y=4)
    conn, X, _ = creator.create_poisson_problem()
    et = pt.get_element("quad4")
    nelems, nn = conn.shape
    nq, nd = et.nquads, 2
    out = {}
    for name, mod in (("port", pyfem), ("jax", jpyfem)):
        Xe = np.zeros((nelems, nn, nd))
        mod.scatter_node_to_elem(conn, X, Xe)
        Jq = np.zeros((nelems, nq, nd, nd))
        mod.compute_jtrans(Xe, et.shape_grads, Jq)
        detJq = np.zeros((nelems, nq))
        mod.compute_jdet(Jq, detJq)
        invJq = np.zeros_like(Jq)
        Ngrad = np.zeros((nelems, nq, nn, nd))
        mod.compute_basis_grad(Jq, detJq, et.shape_grads, invJq, Ngrad)
        ue = (X @ np.array([2.0, -3.0]))[conn]
        data_q = np.zeros((nelems, nq))
        mod.compute_elem_interp(et.shape_vals, ue, data_q)
        out[name] = (Xe, Jq, detJq, invJq, Ngrad, data_q,
                     mod.create_dof(X.shape[0], nelems, nn, 2, conn))
    Xe, Jq, detJq, invJq, Ngrad, data_q, (dof, den, cdof) = out["port"]
    np.testing.assert_array_equal(Xe, X[conn])
    assert (detJq > 0).all()
    eye = np.einsum("eqij,eqjk->eqik", Jq, invJq)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(2), eye.shape),
                               atol=1e-12)
    gu = np.einsum("eqnl,en->eql", Ngrad, (X @ np.array([2.0, -3.0]))[conn])
    np.testing.assert_allclose(gu, np.broadcast_to([2.0, -3.0], gu.shape),
                               atol=1e-12)
    assert cdof.shape == (nelems, 2 * nn)
    np.testing.assert_array_equal(cdof[:, 0::2], 2 * conn)
    for a, b in zip(out["port"][:6], out["jax"][:6]):
        assert _rel(a, b) <= 1e-13
    for a, b in zip(out["port"][6], out["jax"][6]):
        np.testing.assert_array_equal(a, b)


def test_assembler_plot_agg():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    creator = pyfem.ProblemCreator(nnodes_x=9, nnodes_y=7)
    conn, X, dof_fixed = creator.create_poisson_problem()
    q = pyfem.QuadratureBilinear2D()
    model = pyfem.LinearPoisson(X, conn, dof_fixed, None, q,
                                pyfem.BasisBilinear2D(q), gfunc, device=DEV)
    asm = pyfem.Assembler(model)
    u = asm.solve(method="cg", rtol=1e-12)
    fig, ax = plt.subplots()
    try:
        asm.plot(u, ax, levels=8)
        assert len(ax.collections) > 0
    finally:
        plt.close(fig)
