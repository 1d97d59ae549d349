"""PyTorch port, 3D topology optimization on CPU (float64).

Gates against the JAX package on a 9x5x5 hex8 block cantilever (the
reference's 3D topology problem, topo.py:150-152, at a small size):

* ``DeviceTopo`` follows the JAX ``DeviceTopo`` for 5 iterations (state
  rtol 1e-8): x within 1e-6 relative, objectives within 1e-6 — and so
  does a run resumed from the JAX run's 3D checkpoint;
* stopping at iteration 2 and resuming repeats the 5-iteration run bit
  for bit;
* the host loop (``TopoProblem`` + ``MMA``) follows the JAX loops: with
  the "direct" state solver the JAX host loop, with "gmg" the JAX
  ``DeviceTopo`` (which tests/test_topo_device.py holds to the JAX host
  loop on the same solver);
* the 3D structured filter (K4 on full-storage planes in float32, the
  plain ``Stencil3D.matvec`` in float64) agrees with the JAX filter and
  with the general matrix-free path;
* ``GMGAssembler3D.material_planes`` and ``elem_path="einsum"`` (both
  storages) agree with the JAX package, the latter also with the port's
  uniform route, and a solve on it converges.

The JAX ``DeviceTopo`` is compiled once for the module: one instance
runs its 2-iteration checkpoint and then its 5 iterations.  Its state
solve runs on the fine level alone (``min_n=5``: the dense coarse solve
of 675 dof, one PCG iteration), because compiling the JAX package's
243-plane 3D assembly takes ~27 s a level on one core; the port runs
its full 2-level hierarchy, so the JAX run is an exact-solve yardstick
for it.  The kernels (K3, K4, K5) run their plain versions here; the
card runs them in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.opt import DeviceTopo as JDeviceTopo
from pyfem_gpu_testflight_tpu.opt import MMA as JMMA
from pyfem_gpu_testflight_tpu.opt import TopoProblem as JTopoProblem

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.opt import MMA, DeviceTopo, TopoProblem
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth

import torch_threads  # noqa: F401  (one torch thread per worker)

NX, NY, NZ = 9, 5, 5
R0 = 0.1


def _rel(got, ref):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _problem():
    c = fem.ProblemCreator(nnodes_x=NX, nnodes_y=NY, nnodes_z=NZ,
                           element_type="block")
    return c.create_linear_elasticity_problem()


def _pair(structured_filter=True, dtype=torch.float64, jax_min_n=3):
    """JAX and port (model, filter), both models on their GMG grid."""
    conn, X, fixed, force = _problem()
    jm = fem.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0)
    jm.attach_structured_grid(NX, NY, NZ, min_n=jax_min_n)
    pm = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                             dtype=dtype, device="cpu")
    pm.attach_structured_grid(NX, NY, NZ)
    jf = fem.Helmholtz(R0, "hex8", X, conn)
    pf = pt.Helmholtz(R0, "hex8", X, conn, dtype=dtype, device="cpu")
    if structured_filter:
        jf.attach_structured_grid(NX, NY, NZ)
        pf.attach_structured_grid(NX, NY, NZ)
    return (jm, jf), (pm, pf)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX DeviceTopo (fine-level state solve): a 2-iteration run's
    checkpoint, then 5 iterations from the start."""
    (jm, jf), _p = _pair(jax_min_n=5)
    jd = JDeviceTopo(jm, jf, fixed_volume=0.4, rtol=1e-8)
    ck = str(tmp_path_factory.mktemp("jax3d") / "ck2.npz")
    jd.optimize(max_iterations=2, verbose=False, log_every=2,
                checkpoint_path=ck)
    jd.history.clear()
    x, _rho = jd.optimize(max_iterations=5, verbose=False, log_every=2)
    return np.asarray(x), [h["obj"] for h in jd.history], ck


def _port_run(n, **kw):
    _j, (pm, pf) = _pair()
    d = DeviceTopo(pm, pf, fixed_volume=0.4, rtol=1e-8)
    x, _rho = d.optimize(max_iterations=n, verbose=False, log_every=2, **kw)
    return d, x


@pytest.fixture(scope="module")
def port_run():
    """The port's DeviceTopo, 5 iterations from the start."""
    return _port_run(5)


def test_device_topo_3d_matches_jax(jax_run, port_run):
    x_ref, objs_ref, _ck = jax_run
    d, x = port_run
    assert len(d.model._gmg_asm.sizes) == 2
    assert np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-6
    np.testing.assert_allclose([h["obj"] for h in d.history], objs_ref,
                               rtol=1e-6)
    assert all(h["cg_iters"] > 1 and min(h["filter_iters"]) > 0
               for h in d.history)


def test_device_topo_3d_resumes_a_jax_checkpoint(jax_run):
    x_ref, objs_ref, ck = jax_run
    assert np.load(ck)["u_prev"].shape == (3, NZ, NY, NX)
    d, x = _port_run(5, resume=ck)
    assert len(d.history) == 5
    assert np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref) < 1e-6
    np.testing.assert_allclose([h["obj"] for h in d.history], objs_ref,
                               rtol=1e-6)


def test_device_topo_3d_resume_is_bit_identical(port_run, tmp_path):
    d_full, x_full = port_run
    ck = str(tmp_path / "ck.npz")
    _port_run(2, checkpoint_path=ck)
    d_res, x_res = _port_run(5, resume=ck)
    assert torch.equal(x_res, x_full)
    assert [h["obj"] for h in d_res.history] == \
        [h["obj"] for h in d_full.history]
    assert [h["step"] for h in d_res.history] == \
        [h["step"] for h in d_full.history]
    # a checkpoint of another grid is refused
    c = pt.ProblemCreator(5, 3, 3, element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float64, device="cpu")
    f = pt.Helmholtz(R0, "hex8", X, conn, dtype=torch.float64, device="cpu")
    d = DeviceTopo(m.attach_structured_grid(5, 3, 3),
                   f.attach_structured_grid(5, 3, 3))
    with pytest.raises(ValueError, match="u_prev"):
        d.optimize(max_iterations=3, verbose=False, resume=ck)


@pytest.fixture(scope="module")
def jax_host_direct():
    """The JAX host loop (TopoProblem + MMA) on the direct state solve."""
    (jm, jf), _p = _pair(jax_min_n=5)
    jo = JMMA(JTopoProblem(jm, jf, fixed_volume=0.4, solver="direct"),
              {"max_iterations": 5, "verbose": False})
    return np.asarray(jo.optimize()), jo.history


@pytest.mark.parametrize("solver", ["gmg", "direct"])
def test_host_loop_3d_matches_jax(solver, request):
    _j, (pm, pf) = _pair()
    po = MMA(TopoProblem(pm, pf, fixed_volume=0.4, solver=solver),
             {"max_iterations": 5, "verbose": False})
    x = np.asarray(po.optimize())
    if solver == "direct":
        x_ref, hist = request.getfixturevalue("jax_host_direct")
        objs_ref = [h["obj"] for h in hist]
        tol_x, tol = 1e-9, 1e-9
        np.testing.assert_allclose([h["con"][0] for h in po.history],
                                   [h["con"][0] for h in hist], rtol=tol)
    else:
        # the JAX DeviceTopo: the host loop's iterates on the same
        # solver, within its PCG tolerances (tests/test_topo_device.py's
        # gate: x 1e-5, objectives 1e-6)
        x_ref, objs_ref, _ck = request.getfixturevalue("jax_run")
        tol_x, tol = 1e-5, 1e-6
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < tol_x
    np.testing.assert_allclose([h["obj"] for h in po.history], objs_ref,
                               rtol=tol)


def test_structured_filter_3d_matches_jax_and_general():
    (_jm, jf), (_pm, pf) = _pair()
    _j, (_m, pg) = _pair(structured_filter=False)
    # full storage: the 27 planes K4 reads
    assert tuple(pf._coeffK.shape) == (27, NZ, NY, NX)
    x = np.random.default_rng(4).uniform(0.0, 1.0, NX * NY * NZ)
    for name in ("apply", "apply_gradient"):
        ref = getattr(jf, name)(jnp.asarray(x))
        got = getattr(pf, name)(x)
        assert _rel(got, ref) <= 1e-10, name
        assert _rel(got, getattr(pg, name)(x)) <= 1e-10, name


def test_structured_filter_3d_float32_runs_k4_full_storage(monkeypatch):
    """A float32 3D filter's every product is K4's matvec (its plain
    version here) on the 27 full-storage planes."""
    _j, (_m, pf64) = _pair()
    _j, (_m, pf) = _pair(dtype=torch.float32)
    calls = []
    real = fused_smooth.fused_sweep_3d

    def spy(coeff, *a, **kw):
        calls.append((tuple(coeff.shape), kw.get("mode")))
        return real(coeff, *a, **kw)

    monkeypatch.setattr(fused_smooth, "fused_sweep_3d", spy)
    pf.attach_structured_grid(NX, NY, NZ)  # binds the spy
    x = np.random.default_rng(5).uniform(0.0, 1.0, NX * NY * NZ)
    got = pf.apply(x)
    assert got.dtype == torch.float32
    assert calls and set(calls) == {((27, NZ, NY, NX), "matvec")}
    assert _rel(got, pf64.apply(x)) <= 1e-5


def test_material_planes_3d_match_jax():
    rho = np.random.default_rng(6).uniform(0.3, 1.0, (NZ, NY, NX))
    ja = jmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.0, 1.0, p=3.0,
                            dtype=jnp.float64)
    ta = tmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.0, 1.0, p=3.0,
                            dtype=torch.float64, device="cpu")
    got = ta.material_planes(torch.as_tensor(rho))
    ref = ja.material_planes(jnp.asarray(rho))
    assert tuple(got.shape) == (8, NZ - 1, NY - 1, NX - 1)
    assert _rel(got, ref) <= 1e-14


_RHO_E = 0.3 + 0.6 * np.random.RandomState(3).rand(NX * NY * NZ)


@pytest.fixture(scope="module")
def jax_einsum_fine():
    """The JAX einsum route's fine level: eliminated planes and inverse
    diagonal, built as its ``assemble`` builds them (the element matrices
    jitted; the 243-plane assembly eager: jitted, it compiles for over a
    minute)."""
    je = jmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.0, 1.0, "elasticity",
                            elem_path="einsum", p=3.0, dtype=jnp.float64)
    op, Xe, conn32, mask, shape = je.static_levels[0][:5]
    Ke = jax.jit(je._elem_matrices)(Xe, conn32, jnp.asarray(_RHO_E))
    with jax.disable_jit():
        lv = jmg.Level(op, op.assemble(Ke), mask, shape, 3)
        return np.asarray(lv.coeff_e), np.asarray(lv.inv_diag)


@pytest.mark.parametrize("sym", [True, False])
def test_einsum_route_3d_matches_jax_and_uniform(sym, jax_einsum_fine):
    """tests/test_gmg_elem_paths.py's 3D check, on the port: the einsum
    route's eliminated planes against the JAX einsum route (fine level)
    and the port's uniform (K3) route (every level), in the assembler's
    storage."""
    kw = dict(p=3.0, dtype=torch.float64, device="cpu", sym=sym)
    te = tmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.0, 1.0, "elasticity",
                            elem_path="einsum", **kw)
    tu = tmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.0, 1.0, "elasticity", **kw)
    rt = torch.as_tensor(_RHO_E)
    ge, le = te.assemble(rt)
    gu, lu = tu.assemble(rt)
    nk = len(fused_smooth.sym_planes_3d(3)) if sym else 243
    assert len(ge.levels) == 2
    for lv, lvu in zip(ge.levels, gu.levels):
        assert lv.coeff.shape[0] == nk
        assert _rel(lv.coeff, lvu.coeff) <= 1e-13
        assert _rel(lv.inv_diag, lvu.inv_diag) <= 1e-13
    cj, dj = jax_einsum_fine
    assert _rel(fused_smooth.as_full_planes_3d(le.coeff, 3), cj) <= 1e-13
    # inverse diagonal: 0 at fixed dofs here (K3's convention), 1 on the
    # JAX XLA levels; equal on the free dofs
    free = ~le.mask.numpy()
    assert _rel(le.inv_diag.numpy()[free], dj[free]) <= 1e-13
    # a solve on the einsum route: the uniform route's iterations
    b = torch.where(le.mask, 0.0, torch.ones_like(le.inv_diag))
    _x, k, rn = tmg.pcg_gmg(ge, le, b, rtol=1e-8)
    _xu, ku, _rnu = tmg.pcg_gmg(gu, lu, b, rtol=1e-8)
    assert float(rn) <= 1e-8 * float(torch.linalg.norm(b))
    assert 1 < k == ku
