"""PyTorch port, topology optimization on CPU (float64).

Gates against the JAX package:

* ``compliance`` (solver "cg", "direct", "gmg") and ``compliance_grad``
  of both models, the Poisson unweighted objective's adjoint solve
  included (1e-10);
* the structured ``k_dv_sens`` (scatter-free, on an attached uniform
  grid) equals the generic einsum + segment-sum route and the JAX one
  (1e-12), in 2D and 3D;
* the host loop (``TopoProblem`` + ``MMA``) at 65x33 with the direct
  solver stays inside the 2% compliance envelope that
  tests/test_topo_trajectory.py commits (its numbers copied here);
* ``DeviceTopo`` follows the JAX ``DeviceTopo`` for 5 iterations at
  33x17 (state rtol 1e-8): x within 1e-6 relative, objectives within
  1e-6 — and so does a run resumed from a JAX checkpoint;
* stopping at iteration k and resuming repeats the run bit for bit;
* an unattached model is refused, a 3D one steps (3D parity is
  tests/test_torch_topo3d.py's), and the designs are written as VTK.

The kernels (K1, K2, K9) run their plain versions here; the card runs
them in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu.opt import DeviceTopo as JDeviceTopo

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.opt import MMA, DeviceTopo, TopoProblem

import torch_threads  # noqa: F401  (one torch thread per worker)

NX, NY = 33, 17


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _problem(nx=NX, ny=NY):
    c = fem.ProblemCreator(nnodes_x=nx, nnodes_y=ny, element_type="quad")
    return c.create_linear_elasticity_problem()


def _models(physics, nx=NX, ny=NY, structured=False):
    conn, X, fixed, force = _problem(nx, ny)
    if physics == "elasticity":
        jm = fem.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0)
        pm = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                                 dtype=torch.float64, device="cpu")
    else:
        nodes = np.unique(np.asarray(fixed) // 2)
        g = 1.0
        jm = fem.LinearPoisson("quad4", X, conn, nodes, p=3.0,
                               gfunc=lambda x: g + 0.0 * x[..., 0])
        pm = pt.LinearPoisson("quad4", X, conn, nodes, p=3.0,
                              dtype=torch.float64, device="cpu",
                              gfunc=lambda x: g + 0.0 * x[..., 0])
    if structured:
        jm.attach_structured_grid(nx, ny)
        pm.attach_structured_grid(nx, ny)
    return jm, pm


_RHO = np.random.default_rng(0).uniform(0.3, 1.0, NX * NY)


@pytest.mark.parametrize("solver", ["cg", "direct", "gmg"])
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_compliance_and_grad_match_jax(physics, solver):
    jm, pm = _models(physics, structured=solver == "gmg")
    c_ref, u_ref = jm.compliance(jnp.asarray(_RHO), solver=solver)
    c, u = pm.compliance(_RHO, solver=solver)
    assert abs(float(c) - float(c_ref)) <= 1e-10 * abs(float(c_ref))
    assert _rel(u, u_ref) <= 1e-8
    # the gradient on one state, so only the sensitivity is compared
    g_ref = jm.compliance_grad(jnp.asarray(_RHO), u_ref)
    g = pm.compliance_grad(_RHO, torch.as_tensor(np.array(u_ref)))
    assert _rel(g, g_ref) <= 1e-10


def test_poisson_unweighted_compliance_and_adjoint_match_jax():
    jm, pm = _models("poisson")
    c_ref, u_ref = jm.compliance(jnp.asarray(_RHO), solver="direct",
                                 weighted=False)
    c, u = pm.compliance(_RHO, solver="direct", weighted=False)
    assert abs(float(c) - float(c_ref)) <= 1e-10 * abs(float(c_ref))
    g_ref = jm.compliance_grad(jnp.asarray(_RHO), u_ref, weighted=False,
                               solver="direct")
    g = pm.compliance_grad(_RHO, u, weighted=False, solver="direct")
    assert _rel(g, g_ref) <= 1e-10


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_structured_k_dv_sens_matches_generic_and_jax(physics):
    jm, pm = _models(physics, structured=True)
    _jg, gen = _models(physics)
    rng = np.random.default_rng(1)
    phi, psi = rng.standard_normal((2, pm.ndof))
    assert pm._use_structured_sens() and not gen._use_structured_sens()
    s = pm.k_dv_sens(_RHO, phi, psi)
    s_gen = gen.k_dv_sens(_RHO, phi, psi)
    s_ref = jm.k_dv_sens(jnp.asarray(_RHO), jnp.asarray(phi),
                         jnp.asarray(psi))
    assert _rel(s, s_gen) <= 1e-12
    assert _rel(s, s_ref) <= 1e-12
    assert _rel(s_gen, s_ref) <= 1e-12


def test_structured_k_dv_sens_3d_matches_generic():
    n = 5
    c = pt.ProblemCreator(nnodes_x=n, nnodes_y=n, nnodes_z=n,
                          element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    kw = dict(p=3.0, dtype=torch.float64, device="cpu")
    ms = pt.LinearElasticity("hex8", X, conn, fixed, None, force, **kw)
    ms.attach_structured_grid(n, n, n)
    mg = pt.LinearElasticity("hex8", X, conn, fixed, None, force, **kw)
    rng = np.random.default_rng(2)
    rho = rng.uniform(0.3, 1.0, n ** 3)
    phi, psi = rng.standard_normal((2, ms.ndof))
    s = ms.k_dv_sens(rho, phi, psi)
    assert _rel(s, mg.k_dv_sens(rho, phi, psi)) <= 1e-12
    # the JAX package's structured route (GMGAssembler3D.dv_sens)
    jm = fem.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0)
    jm.attach_structured_grid(n, n, n)
    assert jm._use_structured_sens(rho, phi, psi)
    s_ref = jm.k_dv_sens(jnp.asarray(rho), jnp.asarray(phi),
                         jnp.asarray(psi))
    assert _rel(s, s_ref) <= 1e-12


# compliance per MMA iteration of tests/test_topo_trajectory.py (65x33
# quad4 cantilever, E=10, nu=0.3, p=3 RAMP, Helmholtz r0=0.05, V=0.4,
# x0=0.95; float64 direct solves, no rho floor), copied
_ENVELOPE = [
    5.4768841294, 10.5504596353, 19.3075394511, 31.2838943917,
    22.0983252786, 18.3365617108, 16.2732331937, 15.3701587669,
    14.8861421753, 14.5584787468, 14.3140627356, 14.1188241963,
]
_CON_LAST = 0.000556


def test_host_loop_trajectory_within_envelope(tmp_path):
    conn, X, fixed, force = _problem(65, 33)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                                p=3.0, dtype=torch.float64, device="cpu")
    filtr = pt.Helmholtz(0.05, "quad4", X, conn, dtype=torch.float64,
                         device="cpu")
    prob = TopoProblem(model, filtr, fixed_volume=0.4, solver="direct",
                       save_history=True, save_history_every=11,
                       prefix=str(tmp_path))
    opt = MMA(prob, {"max_iterations": len(_ENVELOPE), "verbose": False})
    opt.optimize()
    objs = np.array([h["obj"] for h in opt.history])
    np.testing.assert_allclose(objs, _ENVELOPE, rtol=2e-2)
    assert abs(opt.history[-1]["con"][0] - _CON_LAST) < 5e-3
    head = (tmp_path / "design_0.vtk").read_text().splitlines()[:5]
    assert head[4] == f"POINTS {model.nnodes} double"


def _device_pair():
    jm, pm = _models("elasticity", structured=True)
    conn, X, _f, _l = _problem()
    jf = fem.Helmholtz(0.02, "quad4", X, conn).attach_structured_grid(NX, NY)
    pf = pt.Helmholtz(0.02, "quad4", X, conn, dtype=torch.float64,
                      device="cpu").attach_structured_grid(NX, NY)
    return (jm, jf), (pm, pf)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX DeviceTopo: a 2-iteration run's checkpoint, then 5
    iterations from the start."""
    (jm, jf), _p = _device_pair()
    jd = JDeviceTopo(jm, jf, fixed_volume=0.4, rtol=1e-8)
    ck = str(tmp_path_factory.mktemp("jax") / "ck2.npz")
    jd.optimize(max_iterations=2, verbose=False, log_every=2,
                checkpoint_path=ck)
    jd.history.clear()
    x, _rho = jd.optimize(max_iterations=5, verbose=False, log_every=2)
    return np.asarray(x), [h["obj"] for h in jd.history], ck


def _port_run(n, **kw):
    _j, (pm, pf) = _device_pair()
    d = DeviceTopo(pm, pf, fixed_volume=0.4, rtol=1e-8)
    x, rho = d.optimize(max_iterations=n, verbose=False, log_every=2, **kw)
    return d, x


def test_device_topo_matches_jax(jax_run):
    x_ref, objs_ref, _ck = jax_run
    d, x = _port_run(5)
    assert np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-6
    np.testing.assert_allclose([h["obj"] for h in d.history], objs_ref,
                               rtol=1e-6)
    assert all(h["cg_iters"] > 0 and min(h["filter_iters"]) > 0
               for h in d.history)


def test_device_topo_resumes_a_jax_checkpoint(jax_run):
    x_ref, objs_ref, ck = jax_run
    d, x = _port_run(5, resume=ck)
    assert len(d.history) == 5
    assert np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-6
    np.testing.assert_allclose([h["obj"] for h in d.history], objs_ref,
                               rtol=1e-6)


def test_device_topo_resume_is_bit_identical(tmp_path):
    d_full, x_full = _port_run(4)
    ck = str(tmp_path / "ck.npz")
    _port_run(2, checkpoint_path=ck)
    d_res, x_res = _port_run(4, resume=ck)
    assert torch.equal(x_res, x_full)
    assert [h["obj"] for h in d_res.history] == \
        [h["obj"] for h in d_full.history]
    assert [h["step"] for h in d_res.history] == \
        [h["step"] for h in d_full.history]


def test_device_topo_refuses_3d_and_unattached_models():
    c = pt.ProblemCreator(nnodes_x=5, nnodes_y=3, nnodes_z=3,
                          element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float64, device="cpu")
    f = pt.Helmholtz(0.1, "hex8", X, conn, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):
        DeviceTopo(m, f)
    # 3D is ported (tests/test_torch_topo3d.py): it builds and steps
    m.attach_structured_grid(5, 3, 3)
    f.attach_structured_grid(5, 3, 3)
    d = DeviceTopo(m, f)
    x, rho = d.optimize(max_iterations=1, verbose=False, log_every=1)
    assert len(d.history) == 1 and np.isfinite(d.history[0]["obj"])
    assert d.state[5].shape == (3, 3, 3, 5)


def test_to_vtk_matches_jax(tmp_path):
    from pyfem_gpu_testflight_tpu.io.vtk import to_vtk as j_to_vtk

    conn, X, _f, _l = _problem(9, 5)
    rho = np.random.default_rng(3).uniform(0.0, 1.0, 45)
    j_to_vtk(conn, X, {"rho": rho}, str(tmp_path / "jax.vtk"))
    pt.to_vtk(conn, torch.as_tensor(X), {"rho": torch.as_tensor(rho)},
              str(tmp_path / "port.vtk"))
    assert (tmp_path / "port.vtk").read_text() == \
        (tmp_path / "jax.vtk").read_text()
