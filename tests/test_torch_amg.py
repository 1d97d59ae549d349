"""PyTorch port, smoothed-aggregation AMG-PCG (``unstructured``) against
the JAX package on the same numpy inputs (float64, CPU).

* ``rcm_permutation``, ``rigid_body_modes`` and the greedy aggregation
  identical to the JAX package's; ``_tentative``'s ``Tv`` / ``B_c``
  within 1e-12;
* the host hierarchy: every level's ``n`` equal, its aggregate map
  ``J_dof`` equal, ``Tv``, ``lam`` and ``w_sm`` within 1e-12, and its
  operator (CSR here, DIA there) the same matrix;
* one V-cycle against the JAX ``apply`` within 1e-10;
* ``amg_pcg`` taking the JAX loop's iterations, x within 1e-8;
* ``solve(method="amg")`` against the direct solve at 1e-8 on the tri3
  arm, the tri3 Poisson 33x33 and the tet10 bracket n=5 (the gates of
  ``tests/test_unstructured.py:38-70`` and
  ``tests/test_unstructured3d.py:43-58``);
* rigid-body modes beat translations only (2D, and 3D at n=9 with
  ``max_offsets=8192``);
* the cache: one structural set-up, the same runner, the solutions
  after reuse against direct at 1e-7; host read-backs at most
  iterations/16 + 1.

The JAX references are built once per module (host set-up and one eager
``apply``; ``amg_pcg`` compiles once on the 12x80 arm).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import unstructured as ju

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import solvers, unstructured as pu
from pyfem_gpu_testflight_tpu_torch.examples.bracket3d_topo import (
    bracket_model, synthesize_bracket_inp,
)
from pyfem_gpu_testflight_tpu_torch.examples.torque_arm import (
    arm_model, synthesize_arm_inp,
)

import torch_threads  # noqa: F401  (one torch thread per worker)


def _system(model):
    K = model.assemble_scipy(model.element_jacobian(1.0))
    return model.bc.apply_scipy(K, model.compute_rhs().numpy())


@pytest.fixture(scope="module")
def arm(tmp_path_factory):
    """The 12x80 arm (1,920 dof): model, coordinates, K, b."""
    inp = synthesize_arm_inp(str(tmp_path_factory.mktemp("arm") / "a.inp"),
                             nr=12, nt=80)
    model, X = arm_model(inp, device="cpu")[:2]
    return (model, X) + _system(model)


@pytest.fixture(scope="module")
def arm_deep(tmp_path_factory):
    """The 24x160 arm (7,680 dof): three levels, two of them coarsened."""
    inp = synthesize_arm_inp(str(tmp_path_factory.mktemp("arm") / "a.inp"),
                             nr=24, nt=160)
    model, X = arm_model(inp, device="cpu")[:2]
    K, b = _system(model)
    hj = ju.AMGPreconditioner(K, nd=2, coords=X, dtype=jnp.float64)
    hp = pu.AMGPreconditioner(K, nd=2, coords=X, dtype=torch.float64,
                              device="cpu")
    return K, b, X, hj, hp


def test_rcm_modes_and_aggregation_match_jax(arm):
    model, X, K, b = arm
    np.testing.assert_array_equal(pu.rcm_permutation(K),
                                  ju.rcm_permutation(K))
    for nd, coords in ((2, X), (3, np.random.default_rng(0).uniform(
            size=(50, 3))), (1, X)):
        np.testing.assert_array_equal(pu.rigid_body_modes(coords, nd),
                                      ju.rigid_body_modes(coords, nd))
    agg, n = pu._greedy_aggregate(K)
    agg_j, n_j = ju._greedy_aggregate(K)
    np.testing.assert_array_equal(agg, agg_j)
    assert n == n_j


@pytest.mark.parametrize("nd", [2, 3])
def test_tentative_matches_jax(nd):
    rng = np.random.default_rng(nd)
    nnodes = 240
    agg = rng.integers(0, 70, nnodes)
    agg = np.unique(agg, return_inverse=True)[1]  # ids 0..n_agg-1, ragged
    B = pu.rigid_body_modes(rng.uniform(size=(nnodes, nd)), nd)
    J, Tv, Bc = pu._tentative(agg, nd, B, nd * nnodes)
    J_j, Tv_j, Bc_j = ju._tentative(agg, nd, B, nd * nnodes)
    np.testing.assert_array_equal(J, J_j)
    np.testing.assert_allclose(Tv, Tv_j, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Bc, Bc_j, rtol=0, atol=1e-12)


def test_hierarchy_matches_jax(arm_deep):
    K, b, X, hj, hp = arm_deep
    assert len(hp.levels) == len(hj.levels) >= 3
    np.testing.assert_array_equal(hp.perm.numpy(), np.asarray(hj.perm))
    u = np.random.default_rng(6).standard_normal(K.shape[0])
    for k, (lp, lj) in enumerate(zip(hp.levels, hj.levels)):
        assert lp["n"] == lj["n"]
        for name in ("lam", "w_sm", "w_jac"):
            a, c = getattr(hp, name)[k], getattr(hj, name)[k]
            assert abs(a - c) <= 1e-12 * abs(c), (k, name, a, c)
        np.testing.assert_array_equal(
            hp.structure["levels"][k]["offsets"],
            hj.structure["levels"][k]["offsets"])
        if "J_dof" in lj:
            np.testing.assert_array_equal(lp["J_dof"].numpy(),
                                          np.asarray(lj["J_dof"]))
            np.testing.assert_allclose(lp["Tv"].numpy(), np.asarray(lj["Tv"]),
                                       rtol=0, atol=1e-12)
        # the same operator: CSR (U1's plain version) against JAX's DIA
        v = u[:lp["n"]]
        yj = np.asarray(lj["op"].matvec(lj["vals"], jnp.asarray(v)))
        yp = lp["op"].matvec(torch.as_tensor(v)).numpy()
        np.testing.assert_allclose(yp, yj, rtol=0,
                                   atol=1e-12 * np.abs(yj).max())
        np.testing.assert_allclose(lp["inv_diag"].numpy(),
                                   np.asarray(lj["inv_diag"]), rtol=1e-14)
    assert ("dense" in hp.levels[-1]) == ("dense" in hj.levels[-1])


def test_vcycle_matches_jax(arm):
    model, X, K, b = arm
    hj = ju.AMGPreconditioner(K, nd=2, coords=X, dtype=jnp.float64)
    hp = pu.AMGPreconditioner(K, nd=2, coords=X, dtype=torch.float64,
                              device="cpu")
    r = np.random.default_rng(7).standard_normal(K.shape[0])
    zj = np.asarray(hj.apply(hj._params(), jnp.asarray(r)))
    zp = hp.apply(torch.as_tensor(r)).numpy()
    assert np.abs(zp - zj).max() <= 1e-10 * np.abs(zj).max()
    # the damped-Jacobi smoother's cycle too
    hj = ju.AMGPreconditioner(K, nd=2, coords=X, dtype=jnp.float64,
                              smoother="jacobi")
    hp = pu.AMGPreconditioner(K, nd=2, coords=X, dtype=torch.float64,
                              device="cpu", smoother="jacobi")
    zj = np.asarray(hj.apply(hj._params(), jnp.asarray(r)))
    zp = hp.apply(torch.as_tensor(r)).numpy()
    assert np.abs(zp - zj).max() <= 1e-10 * np.abs(zj).max()


def test_amg_pcg_matches_jax_and_readbacks(arm):
    model, X, K, b = arm
    xj, kj, rnj = ju.amg_pcg(K, b, nd=2, coords=X, rtol=1e-8)
    n0 = solvers.readbacks["amg"]
    xp, kp, rnp = pu.amg_pcg(K, b, nd=2, coords=X, rtol=1e-8, device="cpu")
    reads = solvers.readbacks["amg"] - n0
    assert int(kp) == int(kj), (int(kp), int(kj))
    xj = np.asarray(xj)
    assert np.linalg.norm(xp.numpy() - xj) <= 1e-8 * np.linalg.norm(xj)
    assert abs(float(rnp) - float(rnj)) <= 1e-6 * float(rnj)
    assert 1 <= reads <= int(kp) // solvers.CHECK_EVERY + 1
    # a float32 V-cycle under the float64 CG (the JAX precond_dtype)
    xf, kf, rnf = pu.amg_pcg(K, b, nd=2, coords=X, rtol=1e-8, device="cpu",
                             precond_dtype=torch.float32)
    assert xf.dtype == torch.float64 and float(rnf) <= 1e-8 * np.linalg.norm(b)
    assert abs(int(kf) - int(kp)) <= 2


def _poisson():
    creator = pt.ProblemCreator(nnodes_x=33, nnodes_y=33, element_type="tri")
    conn, X, fixed = creator.create_poisson_problem()
    return pt.LinearPoisson("tri3", X, conn, fixed, None, device="cpu",
                            gfunc=lambda x: torch.ones_like(x[..., 0]))


@pytest.mark.parametrize("case", ["arm", "poisson_tri3", "bracket_tet10"])
def test_solve_amg_matches_direct(tmp_path, arm, case):
    if case == "arm":
        model = arm[0]
        u_amg = model.solve(method="amg", rtol=1e-10)
        u_dir = model.solve(method="direct")
    elif case == "poisson_tri3":
        model = _poisson()
        u_amg = model.solve(method="amg", rtol=1e-10)
        u_dir = model.solve(method="direct")
    else:
        inp = synthesize_bracket_inp(str(tmp_path / "b.inp"), n=5)
        model = bracket_model(inp, device="cpu", p=3.0)[0]
        rho = torch.as_tensor(0.3 + 0.7 * np.random.RandomState(3).rand(
            model.nnodes))
        c_amg, u_amg = model.compliance(rho, solver="amg")
        stats = model.last_solve_stats
        assert stats["method"] == "amg" and stats["iters"] >= 1
        c_dir, u_dir = model.compliance(rho, solver="direct")
        assert abs(float(c_amg - c_dir)) <= 1e-10 * abs(float(c_dir))
    u_amg, u_dir = u_amg.numpy(), u_dir.numpy()
    rel = np.linalg.norm(u_amg - u_dir) / np.linalg.norm(u_dir)
    assert rel < 1e-8, rel
    assert model.last_solve_stats["method"] == "amg"


@pytest.mark.parametrize("dim", [2, 3])
def test_rigid_modes_beat_translations(tmp_path, arm, dim):
    if dim == 2:
        model, X, K, b = arm
        opts = dict(nd=2, rtol=1e-8)
    else:
        inp = synthesize_bracket_inp(str(tmp_path / "b9.inp"), n=9)
        model, X = bracket_model(inp, device="cpu")[:2]
        K, b = _system(model)
        opts = dict(nd=3, rtol=1e-8, max_offsets=8192)
    x6, k6, _ = pu.amg_pcg(K, b, coords=X, device="cpu", **opts)
    x3, k3, _ = pu.amg_pcg(K, b, device="cpu", **opts)
    assert int(k6) < int(k3), (int(k6), int(k3))
    if dim == 2:
        assert int(k6) <= 30, int(k6)
    else:
        from scipy.sparse.linalg import spsolve

        xd = spsolve(K.tocsr(), b)
        rel = np.linalg.norm(x6.numpy() - xd) / np.linalg.norm(xd)
        assert rel < 1e-6, rel


def test_setup_cached_across_solves(tmp_path):
    inp = synthesize_arm_inp(str(tmp_path / "a.inp"), nr=8, nt=48)
    model = arm_model(inp, device="cpu", p=3.0)[0]
    rng = np.random.RandomState(0)
    rho1 = torch.as_tensor(0.4 + 0.6 * rng.rand(model.nnodes))
    rho2 = torch.as_tensor(0.4 + 0.6 * rng.rand(model.nnodes))

    n0 = pu.AMGPreconditioner.n_structure_setups
    u1 = model.solve(method="amg", rho=rho1, rtol=1e-9)
    assert pu.AMGPreconditioner.n_structure_setups == n0 + 1
    run1 = model._amg_cache.get("run")
    pattern1 = model._amg_cache["pattern0"][0]
    u2 = model.solve(method="amg", rho=rho2, rtol=1e-9)
    # no new structural set-up, the same runner and device pattern
    assert pu.AMGPreconditioner.n_structure_setups == n0 + 1
    assert model._amg_cache.get("run") is run1
    assert model._amg_cache["pattern0"][0] is pattern1
    stats = model.last_solve_stats
    assert stats["readbacks"] <= stats["iters"] // solvers.CHECK_EVERY + 1
    for rho, u in [(rho1, u1), (rho2, u2)]:
        u_dir = model.solve(method="direct", rho=rho)
        rel = np.linalg.norm((u - u_dir).numpy()) / np.linalg.norm(
            u_dir.numpy())
        assert rel < 1e-7, rel
    # the JAX package's cached solve takes the same iterations
    jm = fem.LinearElasticity("tri3", model.X_host, model.conn_host,
                              model.bc.fixed, None, model.nodal_force,
                              p=3.0)
    jm.solve(method="amg", rho=jnp.asarray(rho1.numpy()), rtol=1e-9)
    jm.solve(method="amg", rho=jnp.asarray(rho2.numpy()), rtol=1e-9)
    assert jm.last_solve_stats["iters"] == stats["iters"]
