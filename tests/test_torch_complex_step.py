"""PyTorch port, complex-step inputs on CPU (complex128).

A complex density ``rho + 1j*h*p`` keeps its imaginary part through
``element_jacobian``, ``compute_jacobian``, ``compliance(solver=
"direct")`` and ``k_dv_sens``, as in the JAX package, so the reference's
complex-step checks hold on the port (tests/test_elasticity.py:44-75,
tests/test_linear_poisson.py:53-85, tests/test_element_types.py:17-38):

* d(phi^T K psi)/drho against the complex step (h = 1e-30) within
  1e-12, elasticity on quad, tri, block, tet and brick20 meshes and
  Poisson on quad and block, on the JAX tests' 3D meshes and on 32x32
  2D meshes (the JAX tests' are 64x64: a quarter of the CG work);
* the adjoint compliance gradient against the complex step of the
  direct-solve compliance within 1e-10;
* the complex ``Ke`` equal to the JAX complex ``Ke`` within 1e-13;
* complex inputs take the einsum route: after
  ``attach_structured_grid`` (the structured sensitivity is real-only)
  and with ``kernel="cuda"`` (K7 / K8 take float32 only);
* ``SortedSegments`` sums complex data as its real and imaginary sums;
* a complex density with an iterative solver is refused (ValueError).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.assembly import SortedSegments

import torch_threads  # noqa: F401  (one torch thread per worker)

H = 1e-30


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def gfunc(x):
    _x, _y = x[..., 0], x[..., 1]
    return _x * (_x - 5.0) * (_x - 10.0) * _y * (_y - 4.0)


def _mesh(element_type):
    """32x32 in 2D; the JAX tests' 8^3 blocks and 9^3 quadratic."""
    if element_type in ("quad", "tri"):
        return fem.ProblemCreator(32, 32, element_type=element_type)
    n = 9 if element_type in ("tet", "brick20") else 8
    return fem.ProblemCreator(n, n, n, element_type=element_type)


def _model(physics, element_type, package=pt, **kw):
    c = _mesh(element_type)
    if package is pt:
        kw.setdefault("device", "cpu")
    if physics == "elasticity":
        conn, X, fixed, force = c.create_linear_elasticity_problem()
        return package.LinearElasticity(element_type, X, conn, fixed, None,
                                        force, p=5.0, **kw)
    conn, X, fixed = c.create_poisson_problem()
    return package.LinearPoisson(element_type, X, conn, fixed, gfunc=gfunc,
                                 p=5.0, **kw)


CASES = [("elasticity", e) for e in ("quad", "tri", "block", "tet",
                                     "brick20")] + \
    [("poisson", e) for e in ("quad", "block")]


@pytest.mark.parametrize("physics,element_type", CASES)
def test_dKdx_complex_step(physics, element_type):
    model = _model(physics, element_type)
    rng = np.random.RandomState(0)
    phi = rng.rand(model.ndof)
    psi = rng.rand(model.ndof)
    rho = rng.rand(model.nnodes)
    p = rng.rand(model.nnodes)

    dfdrho = p.dot(model.k_dv_sens(rho, phi, psi).numpy())

    K = model.compute_jacobian(torch.as_tensor(rho) + 1j * H
                               * torch.as_tensor(p))
    assert np.iscomplexobj(K.data)
    dfdrho_cs = phi.dot(K.dot(psi)).imag / H
    assert abs((dfdrho - dfdrho_cs) / dfdrho) < 1e-12


@pytest.mark.parametrize("physics,element_type",
                         [("elasticity", "quad"), ("elasticity", "block"),
                          ("poisson", "quad"), ("poisson", "block")])
def test_compliance_gradient_complex_step(physics, element_type):
    model = _model(physics, element_type)
    rng = np.random.RandomState(0)
    rho = rng.rand(model.nnodes)
    p = rng.rand(model.nnodes)

    _c, u = model.compliance(rho, solver="cg")
    grad = p.dot(model.compliance_grad(rho, u).numpy())

    c_cs, u_cs = model.compliance(rho + 1j * H * p, solver="direct")
    assert u_cs.dtype == torch.complex128
    grad_cs = float(c_cs.imag) / H
    assert abs((grad - grad_cs) / grad) < 1e-10


@pytest.mark.parametrize("physics,element_type",
                         [("elasticity", "quad"), ("poisson", "block")])
def test_complex_ke_matches_jax(physics, element_type):
    jm = _model(physics, element_type, package=fem)
    pm = _model(physics, element_type)
    rng = np.random.RandomState(1)
    rho = rng.rand(pm.nnodes) + 1j * H * rng.rand(pm.nnodes)
    ref = np.asarray(jm.element_jacobian(jnp.asarray(rho)))
    got = pm.element_jacobian(rho)
    assert got.dtype == torch.complex128 and np.iscomplexobj(ref)
    assert _rel(got.real, ref.real) <= 1e-13
    assert _rel(got.imag, ref.imag) <= 1e-13


def test_complex_k_dv_sens_takes_the_einsum_route_on_a_grid():
    c = pt.ProblemCreator(9, 5, 5, element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    kw = dict(p=3.0, dtype=torch.float64, device="cpu")
    ms = pt.LinearElasticity("hex8", X, conn, fixed, None, force, **kw)
    ms.attach_structured_grid(9, 5, 5)
    mg = pt.LinearElasticity("hex8", X, conn, fixed, None, force, **kw)
    rng = np.random.default_rng(2)
    rho = rng.uniform(0.3, 1.0, ms.nnodes)
    p = rng.uniform(0.0, 1.0, ms.nnodes)
    phi, psi = rng.standard_normal((2, ms.ndof))
    rho_c = rho + 1j * H * p
    assert ms._use_structured_sens(rho, phi, psi)
    assert not ms._use_structured_sens(rho_c, phi, psi)
    s = ms.k_dv_sens(rho_c, phi, psi)
    assert s.dtype == torch.complex128
    assert torch.equal(s, mg.k_dv_sens(rho_c, phi, psi))
    # its real part is the structured route's real sensitivity
    assert _rel(s.real, ms.k_dv_sens(rho, phi, psi)) <= 1e-12


def test_complex_rho_with_cuda_kernel_takes_the_einsum_route():
    c = pt.ProblemCreator(9, 5)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    kw = dict(p=3.0, dtype=torch.float32, device="cpu")
    mk = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                             kernel="cuda", **kw)
    me = pt.LinearElasticity("quad4", X, conn, fixed, None, force, **kw)
    rng = np.random.default_rng(3)
    rho = rng.uniform(0.3, 1.0, mk.nnodes) + 1j * 1e-3 * rng.uniform(
        0.0, 1.0, mk.nnodes)
    Ke = mk.element_jacobian(rho)
    assert Ke.dtype == torch.complex64
    assert torch.equal(Ke, me.element_jacobian(rho))
    # a real density still takes K7 (its plain version here)
    assert mk.element_jacobian(rho.real).dtype == torch.float32


def test_sorted_segments_sum_complex_data():
    rng = np.random.default_rng(4)
    ids = torch.as_tensor(rng.integers(0, 7, 40))
    seg = SortedSegments(ids, 9)
    data = torch.as_tensor(rng.standard_normal(40)
                           + 1j * rng.standard_normal(40))
    out = seg.sum(data)
    assert out.dtype == torch.complex128 and out.shape == (9,)
    assert torch.equal(out.real, seg.sum(data.real))
    assert torch.equal(out.imag, seg.sum(data.imag))


def test_complex_density_needs_the_direct_solver():
    model = _model("elasticity", "block")
    rho = np.full(model.nnodes, 0.5) + 1j * H
    for solver in ("cg", "gmres"):
        with pytest.raises(ValueError, match="direct"):
            model.compliance(rho, solver=solver)
    model.attach_structured_grid(8, 8, 8)
    with pytest.raises(ValueError, match="direct"):
        model.solve(method="gmg", rho=rho)
    c, _u = model.compliance(rho, solver="direct")
    assert c.dtype == torch.complex128
