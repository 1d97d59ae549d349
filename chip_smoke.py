"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyfem_gpu_testflight_tpu_torch/
csrc``, holds each against its plain PyTorch version on the card, then
drives the main path — the 2D plane-stress GMG-PCG solve at 1025x513
nodes (1,051,650 dof) — through the package's public entry points, and
checks the answers against float64 references.  Exits nonzero on any
failure; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The line before it lists each kernel's launches on the main path, its
error against the plain version and both times.

Phases:
1. device: require CUDA, print the card's name and power limit;
2. build the kernels (nvcc, sm_90a) and time it;
3. kernel vs plain at the main path's shapes (K1 at 1025x513 and 65x33,
   K2 in the four V-cycle variants and niter=8), with times;
4. the bench configuration (p=0, rho=1, Chebyshev-node nu=2, bf16
   smoother copy, flexible PCG, rtol 1e-6): iterations, launch counts,
   float64 true residual, single-shot and chained solve times;
5. ``LinearElasticity.solve(method="gmg")`` at 1025x513 (rho=0.6 and a
   seeded random rho, p=3);
6. at 257x129, p^T u against scipy's sparse direct solve.

Float32 accuracy: the operator is ill-conditioned enough that a float32
solve stalls at the float32 rounding floor of its operator, about
u32 * || |A| |x| || / ||b|| in relative residual (u32 = 2^-24; measured
at 0.8-0.9 of that on CPU up to 257x129).  The float32 solves are held
to that floor.  The 1e-5 float64 targets are held by the same kernels
under a float64 outer PCG (the float32 V-cycle as preconditioner).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
NX, NY = 1025, 513  # bench.py's headline grid, 1,051,650 dof
REL_TOL = 1e-5      # kernel vs plain, relative to max|plain|
FLOOR_FACTOR = 4.0  # float32 true residual <= this x its rounding floor
FAILS = []


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    log(("  ok   " if ok else "  FAIL ") + what)
    if not ok:
        FAILS.append(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds per call from CUDA events (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(got, ref, where=None):
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if where is not None:
        d, r = d[where], r[where]
    return float(d.max()), float(d.max() / r.max())


def problem(nx, ny):
    from pyfem_gpu_testflight_tpu_torch import ProblemCreator

    c = ProblemCreator(nnodes_x=nx, nnodes_y=ny, element_type="quad")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return conn, X, fixed, force, float(X[:, 0].max()), float(X[:, 1].max())


def f64_operator(nx, ny, Lx, Ly, rho, p, dev):
    """float64 BC-eliminated planes by the plain path: (A., |A|., planes)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a = multigrid.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=p,
                               dtype=torch.float64, device=dev)
    st = a.static_levels[0]
    c, _ = fa.assemble_pack_2d_plain(
        rho.to(dtype=torch.float64, device=dev).reshape(ny, nx), st.maskf,
        st.W, a.N, nd=2, p=p,
    )
    c = c.reshape(2, 2, 3, 3, ny, nx)
    ca = c.abs()
    return (lambda u: st.op.matvec(c, u)), (lambda u: st.op.matvec(ca, u)), c


def residuals(mv64, mvabs, b, x):
    """(float64 true relative residual, float32 rounding floor)."""
    import torch

    b64, x64 = b.to(torch.float64), x.to(torch.float64)
    bn = float(torch.linalg.norm(b64))
    true = float(torch.linalg.norm(b64 - mv64(x64))) / bn
    floor = 2.0 ** -24 * float(torch.linalg.norm(mvabs(x64.abs()))) / bn
    return true, floor


def accuracy_solve(gmg32, mv64, b, rtol=1e-11):
    """float64 flexible PCG, the float32 kernel V-cycle as preconditioner."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid

    pre = lambda r: gmg32.apply(r.to(torch.float32)).to(torch.float64)
    return multigrid.pcg(mv64, pre, b.to(torch.float64), rtol=rtol,
                         maxiter=200, flexible=True)


def phase_kernels(dev):
    """Phase 3: each kernel against its plain version on the card."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    rng = np.random.default_rng(SEED)
    res = {}
    for nx, ny in ((NX, NY), (65, 33)):
        a = multigrid.GMGAssembler(nx, ny, (nx - 1) / (ny - 1), 1.0,
                                   "elasticity", p=3.0, device=dev)
        st = a.static_levels[0]
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                              dtype=torch.float32, device=dev)
        args = (rho, st.maskf, st.W, a.N)
        kw = dict(nd=2, p=3.0, lp_dtype=torch.bfloat16)
        ck, dk, lk = fa.assemble_pack_2d(*args, **kw)
        cp, dp, _ = fa.assemble_pack_2d_plain(*args, **kw)
        torch.cuda.synchronize()
        free = st.maskf > 0
        ea, er = rel_err(ck, cp)
        ia, ir = rel_err(dk, dp, free)
        la, lr = rel_err(lk, cp)
        log(f"K1 {nx}x{ny}: planes rel {er:.2e} (abs {ea:.2e}), inv_diag "
            f"free rel {ir:.2e}, bf16 copy vs plain f32 rel {lr:.2e}")
        check(er <= REL_TOL, f"K1 {nx}x{ny} planes within {REL_TOL:g}")
        check(ir <= REL_TOL, f"K1 {nx}x{ny} inv_diag within {REL_TOL:g}")
        check(bool((dk[~free] == 0).all()), f"K1 {nx}x{ny} inv_diag 0 fixed")
        check(torch.equal(lk, ck.to(torch.bfloat16)),
              f"K1 {nx}x{ny} bf16 copy == its f32 planes rounded")
        check(lr <= 2.0 ** -8, f"K1 {nx}x{ny} bf16 copy within 1 bf16 ulp")
        if (nx, ny) == (NX, NY):
            res["K1"] = dict(max_abs_err=max(ea, ia),
                             ms=cuda_ms(lambda: fa.assemble_pack_2d(
                                 *args, **kw), 50),
                             plain_ms=cuda_ms(
                                 lambda: fa.assemble_pack_2d_plain(
                                     *args, **kw), 10))
            fine = (ck, dk, lk, st.mask)
    log(f"K1 {NX}x{NY}: kernel {res['K1']['ms']:.4f} ms, plain "
        f"{res['K1']['plain_ms']:.4f} ms")

    ck, dk, lk, mask = fine
    field = lambda: torch.as_tensor(rng.standard_normal((2, NY, NX)),
                                    dtype=torch.float32, device=dev)
    b = torch.where(mask, 0.0, field())
    x0 = torch.where(mask, 0.0, field())
    xr = field()
    om2 = multigrid.smoothing_omegas(2, 2.3)
    variants = {
        "presmooth_resid_bf16": ((lk, dk, b, None),
                                 dict(niter=2, want_resid=True, omega=om2)),
        "postsmooth_bf16": ((lk, dk, b, x0),
                            dict(niter=2, omega=om2[::-1])),
        "postsmooth_resid_f32": ((ck, dk, b, x0),
                                 dict(niter=2, want_resid=True,
                                      omega=om2[::-1])),
        "matvec_f32": ((ck, dk, None, xr),
                       dict(niter=0, want_resid=True, neg_resid=True)),
        "niter8_f32": ((ck, dk, b, None),
                       dict(niter=8, want_resid=True, omega=0.7)),
    }
    worst_abs = 0.0
    for name, (a, kw) in variants.items():
        got = fs.fused_sweeps_2d(*a, **kw)
        ref = fs.fused_sweeps_2d_plain(*a, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        worst_abs = max([worst_abs] + [e[0] for e in errs])
        ms = cuda_ms(lambda: fs.fused_sweeps_2d(*a, **kw), 50)
        pms = cuda_ms(lambda: fs.fused_sweeps_2d_plain(*a, **kw), 10)
        log(f"K2 {name}: rel " + ", ".join(f"{e[1]:.2e}" for e in errs)
            + f"; kernel {ms:.4f} ms, plain {pms:.4f} ms")
        check(all(e[1] <= REL_TOL for e in errs),
              f"K2 {name} within {REL_TOL:g}")
        if name == "matvec_f32":  # one launch: the per-launch time
            res["K2"] = dict(ms=ms, plain_ms=pms)
    # 8 Chebyshev-node sweeps damp the residual far below b, so its
    # rounding is measured against max|b|, the scale it is computed at
    kw = dict(niter=8, want_resid=True,
              omega=multigrid.smoothing_omegas(8, 2.3))
    (xk, rk), (xp, rp) = (fs.fused_sweeps_2d(ck, dk, b, None, **kw),
                          fs.fused_sweeps_2d_plain(ck, dk, b, None, **kw))
    ex, rr = rel_err(xk, xp), rel_err(rk, rp)
    bmax = float(b.abs().max())
    log(f"K2 niter8_cheby: x rel {ex[1]:.2e}; r rel {rr[1]:.2e} of "
        f"max|r|, {rr[0] / bmax:.2e} of max|b| (max|r|/max|b| "
        f"{float(rp.abs().max()) / bmax:.2e})")
    check(ex[1] <= REL_TOL and rr[0] <= REL_TOL * bmax,
          f"K2 niter8_cheby x and r within {REL_TOL:g} (r of max|b|)")
    res["K2"]["max_abs_err"] = max(worst_abs, ex[0], rr[0])
    return res


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar, planar_to_interleave,
    )

    # 2. build
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")

    # 3. kernels vs plain
    kres = phase_kernels(dev)

    # 4. main path: bench.py run_2d's speed step through the port
    conn, X, fixed, force, Lx, Ly = problem(NX, NY)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler(
        NX, NY, Lx, Ly, "elasticity", p=0.0, dtype=torch.float32,
        device=dev, nu_pre=2, nu_post=2, min_n=5, coarse_dense_max=4096,
        smoother_dtype=torch.bfloat16, omega="cheby",
    )
    log(f"main path: {model.ndof} dof, levels {asm.sizes}")
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    rhs = model.compute_rhs()

    def step(rho, rhs, chain):
        rho = rho + 0.0 * chain[0]
        gmg, lv0 = asm.assemble(rho)
        b = torch.where(lv0.mask, 0.0,
                        interleave_to_planar(rhs, 2).reshape(2, NY, NX))
        x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                                     flexible=True)
        return planar_to_interleave(x.reshape(-1), 2), k, rn, b, gmg

    t0 = time.time()
    step(rho, rhs, rhs)  # first call: library and allocator warm-up
    torch.cuda.synchronize()
    log(f"bench config: first (cold) solve {1e3 * (time.time() - t0):.1f} "
        f"ms host clock")
    _cuda.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    u, k, rn, b, gmg = step(rho, rhs, rhs)
    e1.record()
    e1.synchronize()
    counts = dict(_cuda.launches)
    single_ms = e0.elapsed_time(e1)
    log(f"bench config: {k} PCG iterations (JAX reference: 7), "
        f"||r||/||b|| {float(rn) / float(torch.linalg.norm(b)):.3e}, "
        f"launches {counts}, single-shot {single_ms:.3f} ms")
    check(k <= 8, "bench config converges in <= 8 iterations")
    check(float(rn) <= 1e-6 * float(torch.linalg.norm(b)),
          "bench config PCG residual <= rtol")
    check(bool(torch.isfinite(u).all()) and u.shape == (model.ndof,),
          "bench config solution finite, shape (ndof,)")
    check(all(v > 0 for v in counts.values()), "K1 and K2 launched")
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho, 0.0, dev)
    x = interleave_to_planar(u, 2).reshape(2, NY, NX)
    true, floor = residuals(mv64, mvabs, b, x)
    log(f"bench config: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f}); <= 1e-5: {true <= 1e-5}")
    check(true <= FLOOR_FACTOR * floor,
          f"bench config true residual <= {FLOOR_FACTOR:g} x float32 floor")
    xa, ka, rna = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    log(f"float64 outer PCG, float32 kernel V-cycle: {ka} iterations, "
        f"true residual {true_a:.3e}")
    check(true_a <= 1e-5, "float64-outer solve true residual <= 1e-5")

    n_chain = 10
    e0.record()
    for _ in range(n_chain):
        u, k, rn, _, _ = step(rho, rhs, u)
    e1.record()
    e1.synchronize()
    chained_ms = e0.elapsed_time(e1) / n_chain
    log(f"bench config: chained {chained_ms:.3f} ms/solve over {n_chain}")

    # 5. model entry point
    for label, p_, rho_m in (
        ("rho=0.6", 3.0, 0.6),
        ("rho~U[0.3,1]", 3.0,
         np.random.default_rng(SEED + 1).uniform(0.3, 1.0, NX * NY)),
    ):
        m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=p_,
                                dtype=torch.float32, device=dev)
        m.attach_structured_grid(NX, NY)
        t0 = time.time()
        um = m.solve(method="gmg", rho=rho_m, rtol=1e-6)
        torch.cuda.synchronize()
        st = m.last_solve_stats
        log(f"LinearElasticity.solve gmg {label}: {st['iters']} iterations, "
            f"||r|| {st['resnorm']:.3e}, {time.time() - t0:.3f} s")
        check(bool(torch.isfinite(um).all()), f"model solve {label} finite")

    # 6. scipy check at 257x129
    import scipy.sparse.linalg as spla

    nx, ny = 257, 129
    conn, X, fixed, force, Lx, Ly = problem(nx, ny)
    rho_s = np.random.default_rng(SEED + 2).uniform(0.3, 1.0, nx * ny)
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float32, device=dev)
    m.attach_structured_grid(nx, ny)
    um = m.solve(method="gmg", rho=rho_s, rtol=1e-6)
    mv64, mvabs, c64 = f64_operator(nx, ny, Lx, Ly, torch.as_tensor(rho_s),
                                    3.0, "cpu")
    b = torch.where(
        m.bc.mask.cpu(), 0.0, m.compute_rhs().cpu().to(torch.float64)
    )
    bp = interleave_to_planar(b, 2).reshape(2, ny, nx)
    K = stencil_csr(c64, nx, ny)
    u_ref = planar_to_interleave(torch.as_tensor(spla.spsolve(
        K, bp.reshape(-1).numpy())), 2).numpy()
    p_vec = np.random.RandomState(123).rand(m.ndof)
    ptu = lambda u: float(p_vec @ np.asarray(u, np.float64))
    rel = abs(ptu(um.cpu()) - ptu(u_ref)) / abs(ptu(u_ref))
    true, floor = residuals(
        mv64, mvabs, bp, interleave_to_planar(um.cpu(), 2).reshape(2, ny, nx)
    )
    log(f"257x129 float32 gmg: p^T u rel err vs scipy {rel:.3e}; true "
        f"residual {true:.3e} (floor {floor:.3e})")
    check(true <= FLOOR_FACTOR * floor,
          f"257x129 true residual <= {FLOOR_FACTOR:g} x float32 floor")
    a32 = multigrid.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=3.0,
                                 device=dev)
    g32, _ = a32.assemble(torch.as_tensor(rho_s, dtype=torch.float32,
                                          device=dev))
    mv64d, _, _ = f64_operator(nx, ny, Lx, Ly, torch.as_tensor(rho_s), 3.0,
                               dev)
    xa, ka, _ = accuracy_solve(g32, mv64d, bp.to(dev))
    rel_a = abs(ptu(planar_to_interleave(xa.reshape(-1), 2).cpu())
                - ptu(u_ref)) / abs(ptu(u_ref))
    log(f"257x129 float64 outer PCG ({ka} iterations): p^T u rel err vs "
        f"scipy {rel_a:.3e}")
    check(rel_a <= 1e-5, "257x129 p^T u within 1e-5 of scipy")

    # summary
    k1, k2 = kres["K1"], kres["K2"]
    kernels = [
        dict(name="assemble_pack_2d", route="cuda",
             source="pyfem_gpu_testflight_tpu_torch/csrc/assemble_2d.cu",
             replaces="pyfem_gpu_testflight_tpu/ops/pallas_assemble.py:192",
             launches=counts["pyfem_assemble_2d"], **k1),
        dict(name="fused_sweeps_2d", route="cuda",
             source="pyfem_gpu_testflight_tpu_torch/csrc/smooth_2d.cu",
             replaces="pyfem_gpu_testflight_tpu/ops/pallas_smooth.py:369",
             launches=counts["pyfem_smooth_2d"], **k2),
    ]
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    log(f"single-shot {single_ms:.3f} ms, chained {chained_ms:.3f} ms/solve "
        f"({card})")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


def stencil_csr(c, nx, ny):
    """scipy CSR of (2, 2, 3, 3, ny, nx) stencil planes, planar dofs."""
    import scipy.sparse as sp

    c = c.cpu().numpy()
    npl = ny * nx
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    rows, cols, vals = [], [], []
    for ca in range(2):
        for cb in range(2):
            for dy in range(3):
                for dx in range(3):
                    jy, jx = iy + dy - 1, ix + dx - 1
                    v = c[ca, cb, dy, dx]
                    ok = ((jy >= 0) & (jy < ny) & (jx >= 0) & (jx < nx)
                          & (v != 0.0))
                    rows.append(ca * npl + iy[ok] * nx + ix[ok])
                    cols.append(cb * npl + jy[ok] * nx + jx[ok])
                    vals.append(v[ok])
    return sp.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(2 * npl, 2 * npl),
    )


if __name__ == "__main__":
    sys.exit(main())
