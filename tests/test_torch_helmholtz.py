"""PyTorch port, the Helmholtz density filter (``models/helmholtz.py``).

``apply(x) = K^-1 R x`` and ``apply_gradient(g) = R K^-1 g`` with K =
r0^2 S + M and R = M.  Gated in float64 on CPU (K9's plain version on
the structured path) against the JAX package's filter, both solving at
rtol 1e-12: the general matrix-free Jacobi-CG path, the structured
stencil path in 2D (and in 3D, against the port's own general path),
and the host direct path, results within 1e-10 relative; plus the
filter's integral preservation (natural Neumann BC: 1^T M rho = 1^T M
x) and the blocked convergence check of the structured PCG (iterates,
count and residual equal to a check on every iteration).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import solvers as tsol

torch.set_num_threads(2)

NX, NY, R0 = 33, 17, 0.05
TOL = 1e-10


def _mesh(nx=NX, ny=NY):
    conn, X, _f, _l = fem.ProblemCreator(
        nnodes_x=nx, nnodes_y=ny).create_linear_elasticity_problem()
    return conn, X


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def filters():
    conn, X = _mesh()
    x = np.random.default_rng(0).uniform(0.0, 1.0, NX * NY)
    g = np.random.default_rng(1).standard_normal(NX * NY)
    out = {}
    for path in ("general", "structured"):
        jf = fem.Helmholtz(R0, "quad4", X, conn, rtol=1e-12)
        pf = pt.Helmholtz(R0, "quad4", X, conn, rtol=1e-12, device="cpu")
        if path == "structured":
            jf.attach_structured_grid(NX, NY)
            pf.attach_structured_grid(NX, NY)
        out[path] = (jf, pf)
    return out, x, g


@pytest.mark.parametrize("path", ["general", "structured"])
def test_apply_matches_jax(filters, path):
    fs, x, _g = filters
    jf, pf = fs[path]
    ref = jf.apply(jnp.asarray(x))
    got = pf.apply(x)
    assert got.dtype == torch.float64 and got.shape == (NX * NY,)
    assert _rel(got, ref) <= TOL


@pytest.mark.parametrize("path", ["general", "structured"])
def test_apply_gradient_matches_jax(filters, path):
    fs, _x, g = filters
    jf, pf = fs[path]
    assert _rel(pf.apply_gradient(g), jf.apply_gradient(jnp.asarray(g))) \
        <= TOL


def test_direct_solver_matches_jax():
    conn, X = _mesh(17, 9)
    x = np.random.default_rng(2).uniform(0.0, 1.0, 17 * 9)
    jf = fem.Helmholtz(R0, "quad4", X, conn, solver="direct")
    pf = pt.Helmholtz(R0, "quad4", X, conn, solver="direct", device="cpu")
    assert _rel(pf.apply(x), jf.apply(jnp.asarray(x))) <= TOL
    assert _rel(pf.apply_gradient(x), jf.apply_gradient(jnp.asarray(x))) \
        <= TOL


@pytest.mark.parametrize("path", ["general", "structured"])
def test_filter_preserves_the_integral(filters, path):
    fs, x, _g = filters
    _jf, pf = fs[path]
    rho = pf.apply(x)
    ones = torch.ones(pf.nnodes, dtype=torch.float64)
    lhs = float(ones @ pf.compute_rhs(rho))
    rhs = float(ones @ pf.compute_rhs(x))
    assert abs(lhs - rhs) <= 1e-10 * abs(rhs)


def test_structured_3d_matches_general_path():
    n = 5
    c = pt.ProblemCreator(nnodes_x=n, nnodes_y=n, nnodes_z=n,
                          element_type="block")
    conn, X, _f, _l = c.create_linear_elasticity_problem()
    x = np.random.default_rng(3).uniform(0.0, 1.0, n ** 3)
    gen = pt.Helmholtz(0.2, "hex8", X, conn, rtol=1e-12, device="cpu")
    st = pt.Helmholtz(0.2, "hex8", X, conn, rtol=1e-12, device="cpu")
    st.attach_structured_grid(n, n, n)
    assert _rel(st.apply(x), gen.apply(x)) <= TOL
    assert _rel(st.apply_gradient(x), gen.apply_gradient(x)) <= TOL


def test_structured_pcg_blocked_check_is_bit_identical(monkeypatch):
    conn, X = _mesh()
    x = torch.as_tensor(np.random.default_rng(4).uniform(0, 1, NX * NY))
    pf = pt.Helmholtz(R0, "quad4", X, conn, rtol=1e-12, device="cpu")
    pf.attach_structured_grid(NX, NY)
    n0 = tsol.readbacks["cg"]
    blocked, k_b = pf.apply(x), pf.last_iters
    reads = tsol.readbacks["cg"] - n0
    monkeypatch.setattr(tsol, "CHECK_EVERY", 1)
    each, k_e = pf.apply(x), pf.last_iters
    assert torch.equal(blocked, each) and torch.equal(k_b, k_e)
    assert int(k_e) > 16 and reads <= int(k_e) // 16 + 1


def test_size_and_option_checks():
    conn, X = _mesh(9, 5)
    pf = pt.Helmholtz(R0, "quad4", X, conn, device="cpu")
    with pytest.raises(ValueError):
        pf.apply(np.ones(7))
    with pytest.raises(ValueError):
        pf.attach_structured_grid(9, 4)
    with pytest.raises(ValueError):
        pt.Helmholtz(R0, "quad4", X, conn, solver="amg", device="cpu")
