"""Rank programs of the port's multi-rank CPU tests.

``tests/test_torch_shard*.py`` build their JAX references in the parent
process and run these functions on spawned gloo ranks through
``parallel.launch.run_ranks``.  A spawned rank imports this module by
name, so it imports torch, numpy and the port only, never JAX (the test
modules do).  Each function takes (rank, world, ...) and returns plain
numpy arrays and numbers; every rank runs on the CPU with one torch
thread.
"""

import numpy as np
import torch

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar
from pyfem_gpu_testflight_tpu_torch.parallel import (
    ShardedAMGPCG,
    ShardedElasticity,
    ShardedGMG2D,
    ShardedGMG3D,
    ShardedPoisson,
    make_mesh,
    run_ranks,
    sharded_amg_pcg,
)

F64 = torch.float64
# seconds a test's ranks may take before the run is ended (each file's
# ranks finish in a few seconds on one core)
TIMEOUT = 240.0


def spawn(fn, world, *args):
    """``fn`` on ``world`` CPU gloo ranks, one torch thread each."""
    return run_ranks(fn, world, args=args, threads=1, timeout=TIMEOUT)


def _np(t):
    return t.detach().cpu().numpy()


def elasticity(dims, p=3.0, dtype=F64, etype=None):
    """(model, X, conn) of ProblemCreator's cantilever on the CPU."""
    et = etype or ("quad" if len(dims) == 2 else "block")
    c = pt.ProblemCreator(*dims, element_type=et)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    name = {"quad": "quad4", "block": "hex8", "tri": "tri3"}[et]
    m = pt.LinearElasticity(name, X, conn, fixed, None, force, p=p,
                            dtype=dtype, device="cpu")
    return m, X, conn


def planes(model, dims):
    nd = model.ndof_per_node
    return interleave_to_planar(model.compute_rhs(), nd).reshape(
        (nd,) + tuple(dims[::-1]))


def lengths(X):
    return [float(X[:, k].max()) for k in range(X.shape[1])]


# -- the mesh functions and element sharding (test_torch_sharding.py) -------


def sharding_ranks(rank, world):
    mesh = make_mesh(world, device="cpu")
    out = {"rank": rank, "transport": mesh.transport}
    # exchange: rank r sends r to r+1 and -r to r-1
    me = torch.full((2, 3), float(rank), dtype=F64)
    lo, hi = mesh.exchange(me, -me)
    out["lo"], out["hi"] = _np(lo), _np(hi)
    out["gather"] = _np(mesh.all_gather(torch.full((2,), float(rank)), 0))
    out["reduce"] = float(mesh.all_reduce(torch.tensor([rank + 1.0]))[0])
    out["max"] = float(mesh.all_reduce(torch.tensor([float(rank)]),
                                       op="max")[0])
    # element-sharded solves (the JAX tests/test_sharding.py problems)
    c = pt.ProblemCreator(21, 17)
    conn, X, fixed = c.create_poisson_problem()
    mp = pt.LinearPoisson("quad4", X, conn, fixed, device="cpu",
                          gfunc=lambda x: x[..., 0] * x[..., 1])
    sp = ShardedPoisson(mesh, X, conn, mp.bc.mask.numpy(),
                        pt.get_element("quad4"))
    u, k = sp.solve(np.ones(mp.nnodes), mp.compute_rhs(), rtol=1e-12)
    out["poisson"] = (_np(u), int(k))
    out["poisson_Xe_rows"] = int(sp.Xe.shape[0])
    out["poisson_padded"] = int(-(-sp.nelems // world) * world)
    me_, X2, conn2 = elasticity((14, 10), p=0.0)
    se = ShardedElasticity(mesh, X2, conn2, me_.bc.mask.numpy(),
                           pt.get_element("quad4"))
    u2, k2 = se.solve(np.ones(me_.nnodes), me_.compute_rhs(), rtol=1e-12)
    out["elasticity"] = (_np(u2), int(k2))
    return out


def raising_ranks(rank, world):
    """Rank 1 raises; the others wait in a collective it never joins."""
    mesh = make_mesh(world, device="cpu")
    if rank == 1:
        raise ValueError("deliberate failure on rank 1")
    mesh.all_reduce(torch.ones(1))
    return rank


# -- sharded GMG (test_torch_sharded_gmg.py) ----------------------------------


def _gmg2d(mesh, dims, dtype, seed=0, **kw):
    m, X, _ = elasticity(dims)
    rho = torch.as_tensor(0.4 + 0.5 * np.random.RandomState(seed).rand(
        m.nnodes)).to(dtype)
    s = ShardedGMG2D(mesh, *dims, *lengths(X), "elasticity", p=3.0,
                     dtype=dtype, **kw)
    return s, rho, planes(m, dims).to(dtype)


def _vcycle_against_single_device(s, rho, b):
    """One V-cycle with its A z of the 2D sharded solver ``s`` (K2 per
    smoothing call on the halo-extended blocks) against the single-device
    ``GMG.apply_resid`` on the same planes: z's relative difference, and
    each A z's relative error against a float64 product of its z."""
    from pyfem_gpu_testflight_tpu_torch.ops.stencil_matvec import (
        stencil_matvec_2d_plain,
    )

    mesh = s.mesh
    gmg, lv0 = s.asm.assemble(rho)
    bz = torch.where(lv0.mask, 0.0, b)
    z1, az1 = gmg.apply_resid(bz)
    hier = s.hierarchy(s._local(rho.reshape(s.shapes[0]), 0,
                                axis=0).contiguous())
    z, az = s._vcycle(hier, s._local(bz, 0), want_az=True)
    n0 = s.shapes[0][0]
    z, az = (mesh.all_gather(v, dim=1)[:, :n0] for v in (z, az))
    c64 = lv0.coeff.double().reshape((2, 2, 3, 3) + tuple(s.shapes[0]))

    def a64(v):
        return stencil_matvec_2d_plain(c64, v.double())

    def rel(u, v):
        return float(torch.linalg.norm((u - v).double())
                     / torch.linalg.norm(v.double()))

    return {"z": rel(z, z1), "az": rel(az, a64(z)),
            "az_single": rel(az1, a64(z1))}


def sharded_gmg_ranks(rank, world):
    mesh = make_mesh(world, device="cpu")
    out = {}
    # 65x33 against the single-device pcg, n_sharded 1 and all
    for ns in (1, None):
        s, rho, b = _gmg2d(mesh, (65, 33), F64, n_sharded=ns)
        x, k, _ = s.solve(rho, b, rtol=1e-11, maxiter=300)
        out[("2d", ns)] = (_np(x), k, s.S)
        mesh.reset_counts()
    # Poisson 33x17 (rho = 1)
    c = pt.ProblemCreator(33, 17)
    conn, X, fixed = c.create_poisson_problem()
    mp = pt.LinearPoisson("quad4", X, conn, fixed, device="cpu",
                          gfunc=lambda x: torch.ones_like(x[..., 0]))
    sp = ShardedGMG2D(mesh, 33, 17, *lengths(X), "poisson", dtype=F64)
    xp, _, _ = sp.solve(torch.ones(mp.nnodes, dtype=F64),
                        mp.compute_rhs().reshape(1, 17, 33), rtol=1e-11)
    out["poisson"] = _np(xp)
    # 3D 9^3 hex8
    m3, X3, _ = elasticity((9, 9, 9))
    rho3 = torch.as_tensor(0.4 + 0.5 * np.random.RandomState(1).rand(
        m3.nnodes))
    s3 = ShardedGMG3D(mesh, 9, 9, 9, *lengths(X3), "elasticity", p=3.0,
                      dtype=F64)
    x3, k3, _ = s3.solve(rho3, planes(m3, (9, 9, 9)), rtol=1e-11,
                         maxiter=300)
    out["3d"] = (_np(x3), k3)
    # the kernel smoothers in float32: one K2 launch per smoothing call,
    # also on bf16 planes; 3D (K4 passes)
    f32 = torch.float32
    for key, kw in (("f32", {}),
                    ("bf16", {"smoother_dtype": torch.bfloat16})):
        s, rho, b = _gmg2d(mesh, (65, 33), f32, **kw)
        x, k, _ = s.solve(rho, b, rtol=1e-7, maxiter=300)
        out[key] = (_np(x), k, s.h)
        if key == "f32":
            out["f32_vcycle"] = _vcycle_against_single_device(s, rho, b)
    s3f = ShardedGMG3D(mesh, 9, 9, 9, *lengths(X3), "elasticity", p=3.0,
                       dtype=f32)
    x3f, k3f, _ = s3f.solve(rho3.float(), planes(m3, (9, 9, 9)).float(),
                            rtol=1e-6, maxiter=200)
    out["3d_f32"] = (_np(x3f), k3f)
    # Chebyshev-node smoothing factors (JAX tests/test_cheby_smooth.py:141)
    mc, Xc, _ = elasticity((33, 17), p=0.0)
    sc = ShardedGMG2D(mesh, 33, 17, *lengths(Xc), "elasticity", dtype=F64,
                      omega="cheby")
    xc, kc, _ = sc.solve(torch.ones(mc.nnodes, dtype=F64),
                         planes(mc, (33, 17)), rtol=1e-8, maxiter=60)
    out["cheby"] = (_np(xc), kc)
    # nonzero Dirichlet values (2D Poisson) and the 3D attach
    vals = 0.3 + 0.01 * np.arange(len(fixed))
    mv = pt.LinearPoisson("quad4", X, conn, fixed, vals, device="cpu",
                          gfunc=lambda x: 1.0 + 0 * x[..., 0])
    mv.attach_sharded_grid(mesh, 33, 17)
    out["dirichlet"] = _np(mv.solve(method="sharded_gmg", rtol=1e-12))
    ma, _, _ = elasticity((9, 9, 9), p=0.0)
    ma.attach_sharded_grid(mesh, 9, 9, 9)
    out["attach3d"] = _np(ma.solve(method="sharded_gmg", rtol=1e-11))
    out["attach3d_stats"] = dict(ma.last_solve_stats)
    # local against global hierarchy assembly, 2D and 3D
    rng = np.random.RandomState(3)
    m2, X2, _ = elasticity((33, 17))
    rho2 = torch.as_tensor(0.3 + 0.6 * rng.rand(m2.nnodes))
    b2 = planes(m2, (33, 17))
    for la in (False, True):
        s = ShardedGMG2D(mesh, 33, 17, *lengths(X2), "elasticity", p=3.0,
                         dtype=F64, local_assembly=la)
        x, k, _ = s.solve(rho2, b2, rtol=1e-10, maxiter=200)
        out[("la2d", la)] = (_np(x), k, s.local_assembly)
    m3b, _, _ = elasticity((9, 9, 9), p=2.0)
    rho3b = torch.as_tensor(0.3 + 0.6 * rng.rand(m3b.nnodes))
    b3b = planes(m3b, (9, 9, 9))
    for la in (False, True):
        s = ShardedGMG3D(mesh, 9, 9, 9, *lengths(X3), "elasticity", p=2.0,
                         dtype=F64, local_assembly=la)
        x, k, _ = s.solve(rho3b, b3b, rtol=1e-10, maxiter=200)
        out[("la3d", la)] = (_np(x), k)
    return out


# -- sharded AMG (test_torch_sharded_amg.py) ----------------------------------


def sharded_amg_ranks(rank, world, systems):
    """``systems``: name -> (K, b, coordinates) of a float64 nd=2 system."""
    mesh = make_mesh(world, device="cpu")
    out = {}
    for name, (K, b, X) in systems.items():
        solver = ShardedAMGPCG(mesh, K, nd=2, coords=X, dtype=F64)
        x, k, rn = solver.solve(b, rtol=1e-10)
        x2, _, _ = sharded_amg_pcg(mesh, K, b, nd=2, coords=X, rtol=1e-8,
                                   dtype=F64)
        out[name] = {"x": _np(x), "k": int(k), "rn": float(rn),
                     "fine_sharded": solver.fine_sharded,
                     "sharded": [p["sharded"] for p in solver.plan],
                     "oneshot": _np(x2)}
    return out


# -- sharded topology optimization (test_torch_sharded_topo.py) ---------------


def topo(dims, mesh=None, r0=0.05):
    """The JAX tests' cantilever (p = 3, float64, Helmholtz radius
    ``r0``): ``ShardedDeviceTopo`` on ``mesh``, else the single-device
    one."""
    m, X, conn = elasticity(dims)
    et = "quad4" if len(dims) == 2 else "block"
    f = pt.Helmholtz(r0, et, X, conn, dtype=F64,
                     device="cpu").attach_structured_grid(*dims)
    if mesh is None:
        m.attach_structured_grid(*dims)
        return pt.opt.DeviceTopo(m, f, fixed_volume=0.4, rtol=1e-9)
    m.attach_sharded_grid(mesh, *dims)
    return pt.opt.ShardedDeviceTopo(m, f, fixed_volume=0.4, rtol=1e-9)


def host_topo(dims, solver, mesh=None):
    """The JAX test's host loop problem: ``TopoProblem`` on the
    cantilever (p = 3, float64), the filter on the structured grid."""
    m, X, conn = elasticity(dims)
    if mesh is None:
        m.attach_structured_grid(*dims)
    else:
        m.attach_sharded_grid(mesh, *dims)
    f = pt.Helmholtz(0.05, "quad4", X, conn, dtype=F64,
                     device="cpu").attach_structured_grid(*dims)
    return pt.opt.TopoProblem(m, f, fixed_volume=0.4, solver=solver)


def sharded_topo_ranks(rank, world, runs, host_iters):
    """``runs``: (key, dims, filter radius, iterations, log_every, resume
    path or None, checkpoint path or None) of ``ShardedDeviceTopo``; then
    the host loop (``TopoProblem(solver="sharded_gmg")`` + ``MMA``) at
    33x17 for ``host_iters`` iterations."""
    mesh = make_mesh(world, device="cpu")
    out = {}
    for key, dims, r0, iters, every, resume, ckpt in runs:
        d = topo(dims, mesh, r0)
        x, rho = d.optimize(max_iterations=iters, verbose=False,
                            log_every=every, resume=resume,
                            checkpoint_path=ckpt)
        out[key] = {"x": _np(x), "rho": _np(rho),
                    "obj": [h["obj"] for h in d.history],
                    "cg": [h["cg_iters"] for h in d.history],
                    "step": [h["step"] for h in d.history]}
    opt = pt.opt.MMA(host_topo((33, 17), "sharded_gmg", mesh),
                     {"max_iterations": host_iters, "verbose": False})
    out["host"] = {"x": np.asarray(opt.optimize(), np.float64),
                   "obj": [h["obj"] for h in opt.history]}
    return out
