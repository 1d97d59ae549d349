"""The multi-rank dry run: nine small sharded solves and their checks.

Port of the JAX package's ``__graft_entry__.dryrun_multichip`` and
``parallel.sharded_gmg.dryrun``: the same nine sub-checks at the same
sizes, on ``world`` spawned ranks of a process group
(``launch.run_ranks``) instead of a virtual device mesh.

1. the element-sharded flagship step (``ShardedElasticity``, 17x9,
   float32, Jacobi-PCG);
2. the sharded 2D GMG-PCG solve (33x17, per-rank hierarchy assembly);
3. that solve, whose smoother is one K2 launch per smoothing call on
   each rank's halo-extended block, against the single-device GMG-PCG
   (``multigrid.pcg_gmg``) on the same hierarchy;
4. the sharded 3D GMG-PCG solve (9^3 hex8);
5. per-rank against global hierarchy assembly;
6. two sharded topology-optimization iterations in 2D (33x17);
7. two in 3D (9^3);
8. the mid-size configuration (17x129), whose local blocks span at
   least two K2 row tiles, against the single-device GMG-PCG;
9. sharded AMG-PCG on an unstructured tri3 mesh (97x9, float64) against
   the single-device ``unstructured.amg_pcg``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dryrun_multichip", "sharded_checks"]


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _elasticity(pt, nx, ny, nz=None, p=0.0, dtype=torch.float32,
                device=None, element_type=None):
    dims = (nx, ny) if nz is None else (nx, ny, nz)
    et = element_type or ("quad" if nz is None else "block")
    creator = pt.ProblemCreator(*dims, element_type=et)
    conn, X, fixed, force = creator.create_linear_elasticity_problem()
    name = {"quad": "quad4", "block": "hex8", "tri": "tri3"}[et]
    model = pt.LinearElasticity(name, X, conn, fixed, None, force, p=p,
                                dtype=dtype, device=device)
    return model, X, conn


def _planes(model, shape):
    from ..ops.dia import interleave_to_planar

    nd = model.ndof_per_node
    return interleave_to_planar(model.compute_rhs(), nd).reshape(
        (nd,) + tuple(shape))


def _plane_diff(sg, ha, hb):
    """Largest difference of two sharded hierarchies' planes on the real
    grid's rows, relative to the largest plane entry (all ranks)."""
    worst = torch.zeros((), dtype=torch.float64, device=sg.device)
    for l, (a, b) in enumerate(zip(ha.levels, hb.levels)):
        nl = sg.nl[l]
        real = max(0, min(nl, sg.shapes[l][0] - sg.rank * nl))
        if real == 0:
            continue
        pa, pb = (t.narrow(1, sg.h, real) for t in (a.ck, b.ck))
        worst = torch.maximum(worst, ((pa - pb).abs().max()
                                      / pb.abs().max()).double())
    return float(sg.mesh.all_reduce(worst, op="max"))


def _single_device(sg, rho, b, rtol):
    """The single-device GMG-PCG (``multigrid.pcg_gmg``) on the sharded
    solver's own assembler: (x, iterations)."""
    from .. import multigrid

    gmg, lv0 = sg.asm.assemble(rho)
    x, k, _ = multigrid.pcg_gmg(gmg, lv0, torch.where(lv0.mask, 0.0, b),
                                rtol=rtol, maxiter=100)
    return x, int(k)


def sharded_checks(mesh, dtype=torch.float32):
    """Checks 2-9 on this rank's mesh (the JAX ``sharded_gmg.dryrun``).

    Returns:
        A dict of the readings (every rank returns the same numbers).
    """
    import pyfem_gpu_testflight_tpu_torch as pt
    from .. import unstructured
    from ..ops.fused_smooth import sweep_plan_2d
    from .sharded_amg import ShardedAMGPCG
    from .sharded_gmg import ShardedGMG2D, ShardedGMG3D

    dev = mesh.device
    nx, ny = 33, 17
    model, X, conn = _elasticity(pt, nx, ny, dtype=dtype, device=dev)
    Lx, Ly = float(X[:, 0].max()), float(X[:, 1].max())
    sgmg = ShardedGMG2D(mesh, nx, ny, Lx, Ly, "elasticity", dtype=dtype)
    rho = torch.ones(model.nnodes, dtype=dtype, device=dev)
    b = _planes(model, (ny, nx))
    x, k, rn = sgmg.solve(rho, b, rtol=1e-6, maxiter=100)
    if not (bool(torch.isfinite(x).all()) and sgmg.local_assembly):
        raise AssertionError("sharded 2D GMG: non-finite solution")
    out = {"ndof": model.ndof, "iters": int(k), "resnorm": float(rn),
           "n_sharded_levels": sgmg.S, "levels": sgmg.asm.sizes,
           "local_assembly": sgmg.local_assembly,
           "collectives": sgmg.last_stats["collectives_solve"]}

    # per-rank against global hierarchy assembly (both K1): every
    # sharded level's planes on the real slabs, and the solves
    sgl = ShardedGMG2D(mesh, nx, ny, Lx, Ly, "elasticity", dtype=dtype,
                       local_assembly=False)
    rho_loc = sgmg._local(rho.reshape(ny, nx), 0, axis=0).contiguous()
    planes = _plane_diff(sgmg, sgmg.hierarchy(rho_loc),
                         sgl.hierarchy(rho_loc))
    xg, kg, _ = sgl.solve(rho, b, rtol=1e-6, maxiter=100)
    rel_la = _rel(x, xg)
    if not (kg == k and planes < 1e-6 and rel_la < 1e-5):
        raise AssertionError(f"local vs global assembly: {kg} vs {k} "
                             f"iterations, planes {planes:.3e}, solution "
                             f"{rel_la:.3e}")
    out.update(local_vs_global_assembly_rel=rel_la,
               local_vs_global_planes=planes)

    # the sharded smoother (one K2 launch per call on the halo-extended
    # local blocks) against the single-device solve
    x1, k1 = _single_device(sgmg, rho, b, 1e-6)
    rel = _rel(x, x1)
    if not (abs(int(k) - k1) <= 1 and rel < 1e-4):
        raise AssertionError(f"sharded vs single-device: {int(k)} vs {k1} "
                             f"iterations, rel {rel:.3e}")
    out.update(iters_single_device=k1, vs_single_device_rel=rel)

    # 3D: one z-sharded hex8 solve
    n = 9
    model3, X3, conn3 = _elasticity(pt, n, n, n, dtype=dtype, device=dev)
    L = [float(X3[:, i].max()) for i in range(3)]
    s3 = ShardedGMG3D(mesh, n, n, n, *L, "elasticity", dtype=dtype)
    x3, k3, rn3 = s3.solve(torch.ones(model3.nnodes, dtype=dtype,
                                      device=dev),
                           _planes(model3, (n, n, n)), rtol=1e-6,
                           maxiter=100)
    if not bool(torch.isfinite(x3).all()):
        raise AssertionError("sharded 3D GMG: non-finite solution")
    out.update(ndof_3d=model3.ndof, iters_3d=int(k3), resnorm_3d=float(rn3))

    # sharded topology optimization, 2D and 3D (two MMA iterations)
    for key, dims, et, X_, conn_ in (("topo", (nx, ny), "quad4", X, conn),
                                     ("topo3d", (n, n, n), "block", X3,
                                      conn3)):
        tm, _, _ = _elasticity(pt, *dims, p=3.0, dtype=dtype, device=dev)
        tm.attach_sharded_grid(mesh, *dims)
        filtr = pt.Helmholtz(0.05, et, np.asarray(X_), conn_, dtype=dtype,
                             device=dev).attach_structured_grid(*dims)
        topo = pt.opt.ShardedDeviceTopo(tm, filtr, fixed_volume=0.4,
                                        rtol=1e-6)
        xt, rhot = topo.optimize(max_iterations=2, verbose=False,
                                 log_every=2)
        if not (bool(torch.isfinite(xt).all())
                and bool(torch.isfinite(rhot).all())):
            raise AssertionError(f"sharded {key}: non-finite design")
        out.update({f"{key}_iters": len(topo.history),
                    f"{key}_obj_last": float(topo.history[-1]["obj"]),
                    f"{key}_cg_iters_last": int(
                        topo.history[-1]["cg_iters"])})

    # mid-size configuration: every rank's extended block spans >= 2 K2
    # row tiles, so tile seams inside one rank's rows are reached
    nxm, nym = 17, 129
    mm, Xm, _ = _elasticity(pt, nxm, nym, dtype=dtype, device=dev)
    Lxm, Lym = float(Xm[:, 0].max()), float(Xm[:, 1].max())
    sm_p = ShardedGMG2D(mesh, nxm, nym, Lxm, Lym, "elasticity",
                        dtype=dtype)
    tiles = sweep_plan_2d(2, sm_p.nl[0] + 2 * sm_p.h, nxm, 2, True,
                          True)[0]["grid"][0]
    if tiles < 2:
        raise AssertionError(f"mid-size config: {tiles} row tile(s)")
    rho_m = torch.ones(mm.nnodes, dtype=dtype, device=dev)
    b_m = _planes(mm, (nym, nxm))
    xm0, km0 = _single_device(sm_p, rho_m, b_m, 1e-6)
    xm1, km1, _ = sm_p.solve(rho_m, b_m, rtol=1e-6, maxiter=100)
    rel_m = _rel(xm1, xm0)
    if not (abs(int(km1) - km0) <= 1 and rel_m < 1e-4):
        raise AssertionError(f"mid-size sharded vs single-device: "
                             f"{int(km1)} vs {km0} iterations, rel "
                             f"{rel_m:.3e}")
    out.update(midsize_ndof=mm.ndof, midsize_row_tiles_per_rank=int(tiles),
               midsize_iters=int(km1), midsize_vs_single_device_rel=rel_m)

    # sharded unstructured AMG (float64) against the single-device solve
    mu, Xu, _ = _elasticity(pt, 97, 9, dtype=torch.float64, device=dev,
                            element_type="tri")
    K_u = mu.assemble_scipy(mu.element_jacobian(1.0))
    K_u, b_u = mu.bc.apply_scipy(K_u, mu.compute_rhs().cpu().numpy())
    xu0, ku0, _ = unstructured.amg_pcg(
        K_u, b_u, nd=2, coords=Xu[:, :2], rtol=1e-8, dtype=torch.float64,
        device=dev)
    samg = ShardedAMGPCG(mesh, K_u, nd=2, coords=Xu[:, :2],
                         dtype=torch.float64)
    xu1, ku1, rnu1 = samg.solve(b_u, rtol=1e-8)
    rel_amg = _rel(xu1, xu0)
    if not (abs(int(ku1) - int(ku0)) <= 1 and rel_amg < 1e-7):
        raise AssertionError(f"sharded AMG: {int(ku1)} vs {int(ku0)} "
                             f"iterations, rel {rel_amg:.3e}")
    out.update(amg_ndof=K_u.shape[0], amg_iters=int(ku1),
               amg_resnorm=float(rnu1),
               amg_sharded_levels=sum(p["sharded"] for p in samg.plan),
               amg_vs_single_device_rel=rel_amg)
    return out


def _dryrun_rank(rank, world, device):
    import pyfem_gpu_testflight_tpu_torch as pt
    from .sharding import ShardedElasticity, make_mesh

    mesh = make_mesh(world, device=device)
    dtype = torch.float32
    model, _, _ = _elasticity(pt, 17, 9, p=3.0, dtype=dtype,
                              device=mesh.device)
    sharded = ShardedElasticity(mesh, model.X_host, model.conn_host,
                                model.bc.mask.cpu().numpy(),
                                pt.get_element("quad4"), p=3.0, dtype=dtype)
    rho = torch.full((model.nnodes,), 0.6, dtype=dtype, device=mesh.device)
    u, iters = sharded.solve(rho, model.compute_rhs(), rtol=1e-5,
                             maxiter=200)
    if not bool(torch.isfinite(u).all()):
        raise AssertionError("element-sharded step: non-finite solution")
    res = sharded_checks(mesh, dtype)
    res.update(world=world, backend=mesh.backend, transport=mesh.transport,
               device=str(mesh.device), ndof_elem=model.ndof,
               cg_iters_elem=int(iters),
               u_inf_elem=float(u.abs().max()))
    return res


def dryrun_multichip(world, device=None, timeout=600.0, verbose=True):
    """The nine sub-checks on ``world`` spawned gloo ranks.

    Args:
        device: each rank's device (None: the CUDA card, every rank on
            ``cuda:(rank % device_count)``; "cpu" for the CPU).
        timeout: seconds for the whole run; a rank that fails or times
            out raises here.

    Returns:
        Rank 0's readings (a dict).
    """
    from .launch import run_ranks

    res = run_ranks(_dryrun_rank, int(world), args=(device,),
                    timeout=timeout)[0]
    if verbose:
        for line in summary_lines(res):
            print(line)
    return res


def summary_lines(res):
    """The dry run's nine lines (the JAX run's, one per sub-check)."""
    return [
        f"dryrun_multichip: {res['world']} ranks ({res['backend']}, "
        f"{res['transport']} transport, {res['device']}), ndof="
        f"{res['ndof_elem']}, cg_iters={res['cg_iters_elem']}, "
        f"|u|_inf={res['u_inf_elem']:.3e}",
        f"dryrun_multichip: sharded 2D GMG-PCG ndof={res['ndof']}, "
        f"iters={res['iters']}, resnorm={res['resnorm']:.3e}",
        f"dryrun_multichip: K2 sharded smoother vs single-device GMG-PCG "
        f"iters={res['iters']} (single device "
        f"{res['iters_single_device']}), "
        f"rel={res['vs_single_device_rel']:.2e}",
        f"dryrun_multichip: sharded 3D GMG-PCG ndof={res['ndof_3d']}, "
        f"iters={res['iters_3d']}, resnorm={res['resnorm_3d']:.3e}",
        f"dryrun_multichip: per-rank hierarchy assembly vs global (K1) "
        f"planes rel={res['local_vs_global_planes']:.2e}, solution "
        f"rel={res['local_vs_global_assembly_rel']:.2e}",
        f"dryrun_multichip: sharded topo iterations={res['topo_iters']}, "
        f"obj={res['topo_obj_last']:.4f}, "
        f"state cg_iters={res['topo_cg_iters_last']}",
        f"dryrun_multichip: sharded 3D topo iterations="
        f"{res['topo3d_iters']}, obj={res['topo3d_obj_last']:.4f}, "
        f"state cg_iters={res['topo3d_cg_iters_last']}",
        f"dryrun_multichip: mid-size config ndof="
        f"{res['midsize_ndof']}, row_tiles/rank="
        f"{res['midsize_row_tiles_per_rank']}, "
        f"iters={res['midsize_iters']}, "
        f"vs-single-device rel={res['midsize_vs_single_device_rel']:.2e}",
        f"dryrun_multichip: sharded unstructured AMG "
        f"ndof={res['amg_ndof']}, iters={res['amg_iters']}, "
        f"sharded_levels={res['amg_sharded_levels']}, "
        f"vs-single-device rel={res['amg_vs_single_device_rel']:.2e}",
    ]
