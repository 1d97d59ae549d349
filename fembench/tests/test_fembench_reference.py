"""The plain float64 reference agrees with the port's plain paths (its
kernels' CPU versions) at tiny grids: the operator and the solve, the
sensitivity, the Helmholtz filter and one MMA update."""

import numpy as np
import pytest
import torch

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.opt import mma as pt_mma
from fembench import loops
from fembench.reference import elasticity as ref
from fembench.reference import helmholtz, mma

F64 = torch.float64


def port_model(dims, dtype=F64):
    etype = "quad4" if len(dims) == 2 else "hex8"
    c = pt.ProblemCreator(*dims, element_type="quad" if len(dims) == 2
                          else "block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity(etype, X, conn, fixed, None, force, p=3.0,
                            dtype=dtype, device="cpu")
    lengths = [float(X[:, k].max()) for k in range(X.shape[1])]
    return m.attach_structured_grid(*dims), lengths, (conn, X)


@pytest.mark.parametrize("dims", [(33, 17), (9, 5, 5)])
def test_solve_matches_the_port(dims):
    m, lengths, _ = port_model(dims)
    rho = loops.smooth_densities(dims, 1, 4, 0.3, 1.0, 3, "cpu", F64)[0]
    u = m.solve(method="gmg", rho=rho, rtol=1e-12)
    g = ref.Grid(dims, lengths, 10.0, 0.3, 3.0, "cpu")
    fixed, f = ref.cantilever(g)
    rg = rho.reshape(g.shape)
    ur, _, rn = ref.solve(g, rg, fixed, f)
    assert rn <= 1e-10
    assert float((u.reshape(ur.shape) - ur).abs().max()
                 / ur.abs().max()) < 1e-9
    # the port's sensitivity of u^T K u at the same u
    s = m.k_dv_sens(rho, ur.reshape(-1), ur.reshape(-1)).reshape(rg.shape)
    sr = g.compliance_sens(rg, ur)
    assert float((s - sr).abs().max() / sr.abs().max()) < 1e-10


def test_lowp_operator_is_a_different_operator():
    dims = (33, 17)
    g = ref.Grid(dims, (2.0, 1.0), 10.0, 0.3, 3.0, "cpu")
    lo = ref.Grid(dims, (2.0, 1.0), 10.0, 0.3, 3.0, "cpu",
                  lowp=torch.bfloat16)
    fixed, f = ref.cantilever(g)
    rho = torch.full(g.shape, 0.7, dtype=F64)
    u, _, _ = ref.solve(g, rho, fixed, f)
    ul, _, _ = ref.solve(lo, rho, fixed, f)
    assert float(torch.linalg.norm(u - ul) / torch.linalg.norm(u)) > 1e-2


def test_filter_matches_the_port():
    dims = (33, 17)
    _, lengths, (conn, X) = port_model(dims)
    pf = pt.Helmholtz(0.05, "quad4", X, conn, dtype=F64, rtol=1e-12,
                      device="cpu").attach_structured_grid(*dims)
    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, len(X)))
    rf = helmholtz.Filter(dims, lengths, 0.05, "cpu")
    xg = x.reshape(rf.shape)
    assert torch.allclose(pf.apply(x).reshape(rf.shape), rf.forward(xg),
                          rtol=0, atol=1e-10)
    assert torch.allclose(pf.apply_gradient(x).reshape(rf.shape),
                          rf.backward(xg), rtol=0, atol=1e-10)


def test_mma_update_matches_the_port():
    n = 500
    rng = np.random.default_rng(1)
    t = lambda a: torch.as_tensor(a, dtype=F64)
    x = t(rng.uniform(0.1, 0.9, n))
    low, upp = x - 0.5, x + 0.5
    g = t(rng.standard_normal(n))
    dc = t(rng.uniform(0.5, 1.5, n)) / n
    lb, ub = torch.zeros(n, dtype=F64), torch.ones(n, dtype=F64)
    ci = t(0.05)
    # at k < 2 the port keeps the asymptotes it is given
    xp, lowp, uppp, _, _ = pt_mma.device_update_body(
        x, x, x, low, upp, g, dc, ci, lb, ub, 0)
    assert torch.equal(lowp, low) and torch.equal(uppp, upp)
    xr = mma.update(x, low, upp, g, dc, float(ci), 0.0, 1.0)
    assert float((xp - xr).abs().max()) < 1e-9
