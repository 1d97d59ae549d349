"""PyTorch port, sharded geometric multigrid on CPU gloo ranks.

The JAX references are built once for the module in this process (the
8-device virtual mesh of tests/conftest.py); the port's solves run on 2
and 4 spawned gloo ranks (``tests/torch_dist.py``), once per rank count
for all the gates below (JAX tests/test_sharded_gmg.py):

* 65x33 elasticity (p = 3, random rho, float64, rtol 1e-11), with one
  sharded level and with all but the coarsest: the solution against the
  JAX single-device ``pcg`` and the JAX ``ShardedGMG2D`` (rel < 1e-10,
  iterations within 1);
* 33x17 Poisson against the JAX direct solve (rel < 1e-9);
* 9^3 hex8 (z-sharded) against the JAX direct solve (rel < 1e-9) and
  the port's single-device ``pcg`` (rel < 1e-10, iterations within 1);
* the kernel smoothers in float32: one K2 launch per smoothing call on
  a block extended by its stencil steps (3: the fine postsmooth with its
  residual, which supplies A z).  One V-cycle against the single-device
  ``GMG.apply_resid`` on the same planes: z within 1e-6 (3.4e-8 read),
  and A z, which the postsmooth gives as b - (b - A z), as close to a
  float64 product as the single device's (within 1.1 times its error;
  6.6e-5 and 6.8e-5 read; a halo one row short reads 31).  The solve
  (rtol 1e-7) against the single-device ``pcg_gmg`` and the JAX float32
  ``ShardedGMG2D``: iterations within 1; the solutions part at
  float32's floor on this p = 3 problem (each ~9e-4 from the float64
  solution; 3.4e-5 from the single device's, whose dots sum in another
  order, and 8.8e-5 from the JAX one, whose planes are assembled by
  other code), held at 1e-4 and 2e-4, and the port's distance to the
  float64 solution at most 1.25 times the JAX one's.  Its bf16 planes
  under flexible PCG (rel < 5e-3); the 3D K4 passes against the port's
  single-device float32 solve (rel < 1e-5, iterations within 1) — the
  plain versions here;
* nonzero Dirichlet values through ``solve(method="sharded_gmg")`` (2D
  Poisson, rhs lift) and the 3D attach, against the JAX direct solves;
* Chebyshev-node smoothing factors (``omega="cheby"``, 33x17, float64,
  JAX tests/test_cheby_smooth.py:141): the iterations of the port's
  single-device ``pcg_gmg`` and its solution within 1e-11;
* per-rank against global hierarchy assembly (K1 / K3 plain here), 2D
  and 3D, float64: the same iteration count and solutions to roundoff.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.dia import interleave_to_planar
from pyfem_gpu_testflight_tpu.parallel import ShardedGMG2D as JShardedGMG2D
from pyfem_gpu_testflight_tpu.parallel import make_mesh as jmake_mesh

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg

import torch_dist
import torch_threads  # noqa: F401  (one torch thread per worker)

WORLDS = (2, 4)


def _jax_problem(dims, p, dtype=jnp.float64):
    et = "quad" if len(dims) == 2 else "block"
    c = fem.ProblemCreator(*dims, element_type=et)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = fem.LinearElasticity("quad4" if len(dims) == 2 else "hex8", X, conn,
                             fixed, None, force, p=p, dtype=dtype)
    return m, [float(X[:, k].max()) for k in range(X.shape[1])]


@pytest.fixture(scope="module")
def refs():
    jax.config.update("jax_enable_x64", True)
    out = {}
    # 65x33: JAX single-device pcg and the JAX sharded solver
    m, L = _jax_problem((65, 33), 3.0)
    rho = jnp.asarray(0.4 + 0.5 * np.random.RandomState(0).rand(m.nnodes))
    b = interleave_to_planar(jnp.asarray(m.compute_rhs()), 2).reshape(
        2, 33, 65)
    asm = jmg.GMGAssembler(65, 33, *L, "elasticity", p=3.0,
                           dtype=jnp.float64)

    @jax.jit
    def ref_step(rho):
        gmg, lv0 = asm.assemble(rho)
        bb = jnp.where(lv0.mask, 0.0, b)
        return jmg.pcg(lv0.matvec, gmg.apply, bb, rtol=1e-11, maxiter=300)

    xr, kr, _ = ref_step(rho)
    out["2d_pcg"] = (np.asarray(xr), int(kr))
    js = JShardedGMG2D(jmake_mesh(8), 65, 33, *L, "elasticity", p=3.0,
                       dtype=jnp.float64)
    xs, ks, _ = js.solve(rho, b, rtol=1e-11, maxiter=300)
    out["2d_sharded"] = (np.asarray(xs), int(ks))
    js32 = JShardedGMG2D(jmake_mesh(8), 65, 33, *L, "elasticity", p=3.0,
                         dtype=jnp.float32)
    xs, ks, _ = js32.solve(rho.astype(jnp.float32), b.astype(jnp.float32),
                           rtol=1e-7, maxiter=300)
    out["2d_sharded_f32"] = (np.asarray(xs, np.float64), int(ks))
    pasm = tmg.GMGAssembler(65, 33, *L, "elasticity", p=3.0,
                            dtype=torch.float32, device="cpu", nu_pre=2,
                            nu_post=2, omega=0.7, min_n=5)
    gmg, lv0 = pasm.assemble(torch.as_tensor(np.asarray(rho)).float())
    x, k, _ = tmg.pcg_gmg(gmg, lv0, torch.where(
        lv0.mask, 0.0, torch.as_tensor(np.asarray(b)).float()), rtol=1e-7,
        maxiter=300)
    out["2d_port_f32"] = (x.double().numpy(), k)
    # direct solves: Poisson, 3D, nonzero Dirichlet values, 3D attach
    c = fem.ProblemCreator(nnodes_x=33, nnodes_y=17, element_type="quad")
    conn, X, fixed = c.create_poisson_problem()
    mp = fem.LinearPoisson("quad4", X, conn, fixed, None,
                           gfunc=lambda x: jnp.ones(x.shape[:-1], x.dtype),
                           dtype=jnp.float64)
    out["poisson"] = np.asarray(mp.solve(method="direct"))
    vals = 0.3 + 0.01 * np.arange(len(fixed))
    mv = fem.LinearPoisson("quad4", X, conn, fixed, vals,
                           gfunc=lambda x: 1.0 + 0 * x[..., 0],
                           dtype=jnp.float64)
    out["dirichlet"] = np.asarray(mv.solve(method="direct"))
    m3, _ = _jax_problem((9, 9, 9), 3.0)
    rho3 = np.asarray(0.4 + 0.5 * np.random.RandomState(1).rand(m3.nnodes))
    out["3d"] = np.asarray(m3.solve(method="direct", rho=rho3))
    ma, _ = _jax_problem((9, 9, 9), 0.0)
    out["attach3d"] = np.asarray(ma.solve(method="direct"))
    # the port's single-device Chebyshev-node solve (33x17, p = 0)
    pc, Xc, _ = torch_dist.elasticity((33, 17), p=0.0)
    casm = tmg.GMGAssembler(33, 17, *torch_dist.lengths(Xc), "elasticity",
                            dtype=torch.float64, device="cpu",
                            omega="cheby")
    gmg, lv0 = casm.assemble(torch.ones(pc.nnodes, dtype=torch.float64))
    x, k, _ = tmg.pcg_gmg(gmg, lv0, torch.where(
        lv0.mask, 0.0, torch_dist.planes(pc, (33, 17))), rtol=1e-8,
        maxiter=60)
    out["cheby"] = (x.numpy(), k)
    # the port's single-device 3D solves (float64 and float32)
    pm, X3, _ = torch_dist.elasticity((9, 9, 9))
    b3 = torch_dist.planes(pm, (9, 9, 9))
    for dt in (torch.float64, torch.float32):
        pasm = tmg.GMGAssembler3D(9, 9, 9, *torch_dist.lengths(X3),
                                  "elasticity", p=3.0, dtype=dt,
                                  device="cpu", sym=False)
        gmg, lv0 = pasm.assemble(torch.as_tensor(rho3).to(dt))
        x, k, _ = tmg.pcg(lv0.matvec, gmg.apply,
                          torch.where(lv0.mask, 0.0, b3.to(dt)),
                          rtol=1e-11 if dt == torch.float64 else 1e-6,
                          maxiter=300)
        out[("3d_port", dt)] = (x.double().numpy(), k)
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request):
    return torch_dist.spawn(torch_dist.sharded_gmg_ranks, request.param)[0]


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n_sharded", [1, None])
def test_sharded_gmg_matches_single_device(ranks, refs, n_sharded):
    x, k, S = ranks[("2d", n_sharded)]
    assert S == (1 if n_sharded == 1 else 3)
    for key in ("2d_pcg", "2d_sharded"):
        xr, kr = refs[key]
        assert _rel(x.reshape(xr.shape), xr) < 1e-10, key
        assert abs(k - kr) <= 1, (key, k, kr)


def test_sharded_gmg_poisson(ranks, refs):
    assert _rel(ranks["poisson"].reshape(-1), refs["poisson"]) < 1e-9


def test_sharded_gmg_3d_matches_single_device(ranks, refs):
    x, k = ranks["3d"]
    u = x.reshape(3, -1).T.reshape(-1)  # planar -> interleaved
    assert _rel(u, refs["3d"]) < 1e-9
    xr, kr = refs[("3d_port", torch.float64)]
    assert _rel(x, xr) < 1e-10
    assert abs(k - kr) <= 1


def test_kernel_smoother_2d(ranks, refs):
    """One K2 launch per smoothing call (h = 3 halo rows: the fine
    postsmooth's two sweeps and its residual), float32: a V-cycle and the
    solve against the single device on the same planes, the solve
    against the JAX float32 ``ShardedGMG2D``; the bf16 smoother planes."""
    x1, k1, h1 = ranks["f32"]
    x2, _, _ = ranks["bf16"]
    assert h1 == 3
    vc = ranks["f32_vcycle"]
    assert vc["z"] < 1e-6, vc
    assert vc["az"] <= 1.1 * vc["az_single"], vc
    xp, kp = refs["2d_port_f32"]
    x1 = x1.reshape(xp.shape)
    assert abs(k1 - kp) <= 1, (k1, kp)
    assert _rel(x1, xp) < 1e-4
    assert _rel(x2.reshape(xp.shape), xp) < 5e-3
    xj, kj = refs["2d_sharded_f32"]
    x64 = refs["2d_sharded"][0]
    assert abs(k1 - kj) <= 1, (k1, kj)
    assert _rel(x1, xj) < 2e-4
    assert _rel(x1, x64) <= 1.25 * _rel(xj, x64)


def test_kernel_smoother_3d(ranks, refs):
    x, k = ranks["3d_f32"]
    xr, kr = refs[("3d_port", torch.float32)]
    assert abs(k - kr) <= 1
    assert _rel(x, xr) < 1e-5


def test_nonzero_dirichlet_and_3d_attach(ranks, refs):
    np.testing.assert_allclose(ranks["dirichlet"], refs["dirichlet"],
                               rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(ranks["attach3d"], refs["attach3d"],
                               rtol=1e-6, atol=1e-9)
    assert ranks["attach3d_stats"]["method"] == "sharded_gmg"


def test_cheby_sharded_matches_single_device(ranks, refs):
    """JAX tests/test_cheby_smooth.py:141: under ``omega="cheby"`` the
    sharded solve takes the single-device solve's iterations, and its
    solution differs by the order of the reductions only (f64)."""
    x, k = ranks["cheby"]
    xr, kr = refs["cheby"]
    assert k == kr, (k, kr)
    assert _rel(x.reshape(xr.shape), xr) < 1e-11


def test_local_assembly_matches_global_assembly(ranks):
    x0, k0, la0 = ranks[("la2d", False)]
    x1, k1, la1 = ranks[("la2d", True)]
    assert (la0, la1) == (False, True)
    assert k0 == k1
    assert np.abs(x1 - x0).max() / np.abs(x0).max() < 1e-12
    x30, k30 = ranks[("la3d", False)]
    x31, k31 = ranks[("la3d", True)]
    assert k30 == k31
    assert np.abs(x31 - x30).max() / np.abs(x30).max() < 1e-12
