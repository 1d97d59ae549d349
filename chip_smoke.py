"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyfem_gpu_testflight_tpu_torch/
csrc``, holds each against its plain PyTorch version on the card, then
drives the port's main paths through the package's public entry
points — the 2D plane-stress GMG-PCG solve at 1025x513 nodes (1,051,650
dof) on its K1, element-matrix (K7) and half-symmetric (K1-sym/K2-sym)
routes, 2D topology optimization at the same width (Helmholtz filter
on K9, GMG state solves, MMA; ``opt.DeviceTopo``), the 3D hex8 GMG-PCG
solve at 65^3 nodes (823,875 dof) on its assembled route, its
on-the-fly route and with full coefficient storage, and the
general-mesh element path (K8 element stiffness, matrix-free
Jacobi-PCG) on a jittered 65^3 hex8 mesh — and checks the answers
against float64 and scipy references.  Exits nonzero on any
failure; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The line before it lists each kernel's launches on its main path (the
counts are zeroed just before that path's solve and read just after),
its error against the plain version, its time, the plain version's
time, its bound and, where one PyTorch call computes the same function,
that call's time.

Phases:
1. device: require CUDA, print the card's name and power limit;
2. build the kernels (one nvcc per source, in parallel) and time it;
3. 2D kernels vs plain (K1 at 1025x513 and 65x33, K2 in the four
   V-cycle variants and niter=8), with times and the CSR matvec time;
3a. 3D kernels vs plain, in half-symmetric and full coefficient storage
   (K3 at 65^3 and 9x7x5 for nd=3 and nd=1, K4 in every mode on f32 and
   bf16 planes, K5 presmooth+resid and postsmooth on bf16 and nu=4),
   with times and the CSR matvec time;
3b. K6, the on-the-fly operator, vs plain at 65^3 (nd=3) and 9x7x5
   (nd=3 and nd=1): matvec, presmooth+resid and postsmooth (nu=2) with
   f32 and bf16 operands, presmooth+resid nu=4, compared pass by pass
   (``k6_passes``), with times, the flop bound and the CSR matvec time;
3c. K7a/K7b (quad4 at 1025x513, 17x9 and a ragged 13x7) and K8 (hex8 at
   65^3, tet10 and brick20 on the 33^3 lattice, elasticity and Poisson)
   vs plain on jittered meshes, with times, both bounds and ptxas's
   registers and spills;
3d. K9 (the 2D stencil product) vs plain at 1025x513, 17x9 and 13x7:
   nd=1 (the Helmholtz filter's planes) and nd=2 (elasticity), float32
   and float64, with times, the bound and the CSR time of each form;
3e. K1-sym and K2-sym (half-symmetric 2D storage) vs plain at the same
   sizes, nd=2 and nd=1, K2-sym in every mode on f32 and bf16 planes,
   with times, bounds and the CSR matvec time;
4. the 2D bench configuration (p=0, rho=1, Chebyshev-node nu=2, bf16
   smoother copy, flexible PCG, rtol 1e-6): iterations, launch counts,
   float64 true residual, single-shot and chained solve times, and where
   the time goes (CUDA-event phase times, device busy share from
   ``torch.profiler``);
4a. the 3D bench configuration (``bench.py --config 3d``: 65^3, p=0,
   rho=1, Chebyshev-node nu=2, bf16 smoother copy, flexible PCG, rtol
   1e-6, coarsest 3^3 solved densely), the same measures, and the peak
   device memory of one assemble+solve;
4b. the same with ``elem_path="otf"`` (K6 on every level but the
   coarsest): iterations and solution against 4a's, the same measures;
4c. the same with ``sym=False`` (all 243 planes): iterations, true
   residual, K4/K5 launches on full planes;
4d. the 2D bench configuration with ``elem_path="cuda"`` (K7a on every
   level, K2 the V-cycle): iterations against phase 4's, K7a launches
   per level, true residual, the solution difference, times, hierarchy
   assembly and peak memory beside phase 4's;
4e. "bench 2D sym": the 2D bench configuration with ``sym=True``
   (K1-sym on every level, K2-sym in every V-cycle variant): iterations
   against phase 4's, launches (no full-storage K1/K2), the breakdown and
   peak memory beside phase 4's;
5. ``LinearElasticity.solve(method="gmg")`` at 1025x513 (rho=0.6 and a
   seeded random rho, p=3);
5a. the same entry on hex8 at 65^3;
5b. the same with ``attach_structured_grid(..., elem_path="otf")``;
5c. ``LinearElasticity("hex8", kernel="cuda", float32).solve(
   method="cg", rtol=1e-6)`` on the jittered 65^3 mesh: K8 launches,
   CG iterations and host read-backs, element_jacobian and solve time,
   where a CG iteration goes, float64 true residual against the
   ``kernel="einsum"`` solve's and the float32 floor, bit-identity of
   two solves, peak memory, K8 against its plain version on the
   solve's inputs;
5d. the same for ``LinearPoisson`` (g = 1), 274,625 dof;
5e. the same for ``LinearPoisson`` on a jittered quad4 1025x513 mesh
   (525,825 dof), K7b's main path;
6. at 257x129, p^T u against scipy's sparse direct solve;
6a. at 17^3 (p=3, seeded rho), the same against scipy;
6b. host scipy direct against the card's CG on jittered quad4 257x129
   (both models) and tet10/brick20 9^3 lattices: float64 by p^T u and
   relative L2, float32 ``kernel="cuda"`` against ``"einsum"`` by their
   float64 true residuals.
7. "topo": ``bench.py --config topo`` at its width (1025x513 quad4
   cantilever, p=3, Helmholtz r0=0.01, ``DeviceTopo(fixed_volume=0.4)``),
   2 warm-up and 20 timed MMA iterations (the bench's 40 cut for time):
   s/iteration, state and filter iteration counts, K1/K2/K9 launches and
   host read-backs per iteration, CUDA-event stage times, busy share,
   peak memory, the first iteration's float32 compliance against a
   float64-outer solve, and a run resumed at iteration 2 against the
   uninterrupted one, bit for bit;

Float32 accuracy: the operator is ill-conditioned enough that a float32
solve stalls at the float32 rounding floor of its operator, about
u32 * || |A| |x| || / ||b|| in relative residual (u32 = 2^-24; measured
at 0.8-0.9 of that on CPU up to 257x129).  The float32 solves are held
to that floor.  The 1e-5 float64 targets are held by the same kernels
under a float64 outer PCG (the float32 V-cycle as preconditioner).

Bounds: the least time for the same work on an H100 SXM, the larger of
(bytes the function must move, each input read once and each output
written once) / 3.35 TB/s and (the float32 operations it needs) / 67
TFLOP/s (float64: / 34 TFLOP/s, K9's float64 forms); for the element stiffness only the upper triangle of the
symmetric Ke is counted (``stiffness_flops``).
K6's operations are the structurally nonzero ones (the dense count of
the TPU kernel's matmuls is printed beside it).
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
NX, NY = 1025, 513  # bench.py's headline grid, 1,051,650 dof
N3 = 65             # bench.py --config 3d: 65^3 nodes, 823,875 dof
REL_TOL = 1e-5      # kernel vs plain, relative to max|plain|
FLOOR_FACTOR = 4.0  # float32 true residual <= this x its rounding floor
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_S = 67e12     # H100 SXM float32 rate outside the tensor cores
F64_FLOP_S = 34e12     # H100 SXM float64 rate outside the tensor cores
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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, flops, flop_s=F32_FLOP_S):
    """(bound_ms, bound_by) for the card's memory rate and the operations'
    rate (float32 by default)."""
    tb, tf = n_bytes / HBM_BYTES_S, flops / flop_s
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def rel_err(got, ref, where=None):
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if where is not None:
        d, r = d[where], r[where]
    return float(d.max()), float(d.max() / r.max())


def problem(nx, ny, nz=None):
    from pyfem_gpu_testflight_tpu_torch import ProblemCreator

    c = ProblemCreator(nnodes_x=nx, nnodes_y=ny, nnodes_z=nz,
                       element_type="quad" if nz is None else "block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return conn, X, fixed, force, [float(X[:, k].max())
                                   for k in range(X.shape[1])]


def f64_operator(nx, ny, Lx, Ly, rho, p, dev):
    """float64 BC-eliminated planes by the plain path: (A., |A|., planes).

    A. is kernel K9 in float64 (the ``--accuracy-op xla64`` operator,
    bench.py:933-1007); |A|. , which only sets the float32 floor, stays
    on the plain stencil product."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops.stencil_matvec import (
        stencil_matvec_2d,
    )

    a = multigrid.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=p,
                               dtype=torch.float64, device=dev)
    st = a.static_levels[0]
    c, _ = fa.assemble_pack_2d_plain(
        rho.to(dtype=torch.float64, device=dev).reshape(ny, nx), st.maskf,
        st.W, a.N, nd=2, p=p,
    )
    c = c.reshape(2, 2, 3, 3, ny, nx)
    ca = c.abs()
    return ((lambda u: stencil_matvec_2d(c, u)),
            (lambda u: st.op.matvec(ca, u)), c)


def f64_operator_3d(n, L, rho, p, dev):
    """float64 3D planes by the plain path: (A., |A|., full planes)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    a = multigrid.GMGAssembler3D(n, n, n, *L, "elasticity", p=p,
                                 dtype=torch.float64, device=dev)
    st = a.static_levels[0]
    c, _ = fa.assemble_pack_3d_plain(
        rho.to(dtype=torch.float64, device=dev).reshape(n, n, n), st.maskf,
        st.W, a.N, nd=3, p=p,
    )
    c = fs.full_planes_3d(c, 3)
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


def stencil_csr(c, shape):
    """torch sparse CSR of full stencil planes (nd, nd, 3.., *shape).

    Rows and columns are planar dofs (component-major); entries that
    are zero or point off the grid are dropped.
    """
    import torch

    nd, dim = c.shape[0], len(shape)
    dev = c.device
    npl = int(np.prod(shape))
    idx = torch.meshgrid(*[torch.arange(n, device=dev) for n in shape],
                         indexing="ij")
    node = torch.arange(npl, device=dev).reshape(shape)
    rows, cols, vals = [], [], []
    for ca, cb in itertools.product(range(nd), range(nd)):
        for off in itertools.product(range(3), repeat=dim):
            v = c[(ca, cb) + off]
            ok = v != 0
            j = [g + o - 1 for g, o in zip(idx, off)]
            flat = torch.zeros_like(node)
            for g, n in zip(j, shape):
                ok &= (g >= 0) & (g < n)
                flat = flat * n + g
            rows.append(ca * npl + node[ok])
            cols.append(cb * npl + flat[ok])
            vals.append(v[ok])
    n = nd * npl
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n),
    ).coalesce().to_sparse_csr()


def scipy_csr(c, shape):
    import scipy.sparse as sp

    A = stencil_csr(c, shape)
    n = A.shape[0]
    return sp.csr_matrix((A.values().cpu().numpy(),
                          A.col_indices().cpu().numpy(),
                          A.crow_indices().cpu().numpy()), shape=(n, n))


def library_matvec_ms(c, shape, x, dtype=None):
    """``torch.sparse.mm`` time of the same operator, CSR (float32, or
    ``dtype``) built outside the timed region (the yardstick; the port
    never calls it)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    A = stencil_csr(c.to(dtype), shape)
    xv = x.to(dtype).reshape(-1, 1)
    ms = cuda_ms(lambda: torch.sparse.mm(A, xv), 20)
    del A
    return ms


def jittered(X, seed, frac=0.1):
    """Interior nodes moved by a seeded uniform +-frac of the lattice
    spacing per coordinate; nodes on the bounding box stay, so the BCs
    and the loads keep their nodes (no uniform-geometry shortcut
    applies)."""
    X = np.array(X, dtype=np.float64)
    lo, hi = X.min(0), X.max(0)
    inner = ~(np.isclose(X, lo) | np.isclose(X, hi)).any(1)
    rng = np.random.default_rng(seed)
    for k in range(X.shape[1]):
        h = (hi[k] - lo[k]) / (len(np.unique(np.round(X[:, k], 9))) - 1)
        X[inner, k] += rng.uniform(-frac * h, frac * h, int(inner.sum()))
    return X


def elem_problem(dims, element_type, seed):
    """A jittered ProblemCreator elasticity problem (conn, X, fixed,
    force)."""
    from pyfem_gpu_testflight_tpu_torch import ProblemCreator

    c = ProblemCreator(*dims, element_type=element_type)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return conn, jittered(X, seed), np.asarray(fixed), force


def make_model(pt, physics, etype, mesh, dtype, kernel, dev):
    """``LinearElasticity`` on ``mesh = (conn, X, fixed, force)``, or
    ``LinearPoisson`` (source 1, the x=0 nodes fixed) on its nodes; p=3."""
    import torch

    conn, X, fixed, force = mesh
    if physics == "elasticity":
        return pt.LinearElasticity(etype, X, conn, fixed, None, force, p=3.0,
                                   dtype=dtype, device=dev, kernel=kernel)
    nd = X.shape[1]
    return pt.LinearPoisson(etype, X, conn, fixed[::nd] // nd,
                            gfunc=lambda x: torch.ones_like(x[..., 0]),
                            p=3.0, dtype=dtype, device=dev, kernel=kernel)


def smooth_density(X, seed):
    """A seeded smooth nodal density in [0.3, 1]: the mean of three
    cosines with wave numbers up to one per domain length.  Used on the
    quadratic elements, whose shape functions are negative at some
    quadrature points: an interpolated U[0.3, 1] field there overshoots
    past RAMP's pole at rho = 1 + 1/p, which makes element matrices
    indefinite (and float32 CG diverge)."""
    rng = np.random.default_rng(seed)
    span = np.ptp(X, axis=0)
    Y = (X - X.min(0)) / np.where(span > 0, span, 1.0)
    t = sum(np.cos(2 * np.pi * Y @ rng.uniform(-1, 1, X.shape[1])
                   + rng.uniform(0, 2 * np.pi)) for _ in range(3))
    return 0.65 + 0.35 * t / 3


def density(etype, X, seed):
    """rho ~ U[0.3, 1] on the linear elements, smooth_density on the
    quadratic ones."""
    if etype in ("tet10", "brick20"):
        return smooth_density(X, seed)
    return np.random.default_rng(seed).uniform(0.3, 1.0, len(X))


def stiffness_flops(nn, nq, nd, dims, nelems):
    """float32 operations an element-stiffness function needs (a fused
    multiply-add counts 2), per element and quadrature point: the
    Jacobian (2 dims^2 nn), its inverse by cofactors (8 in 2D, 42 in
    3D), the shape gradients G (dims (2 dims - 1) nn), the scaled weight
    c = cq w detJ (2), then only the upper triangle of the symmetric Ke,
    ndpe (ndpe + 1) / 2 entries (ndpe = nd nn; the rest is a copy).
    Elasticity: mu c G_n and lam c G_n once per node (2 dims nn + 2),
    two multiply-adds per entry (mu c G_nb G_ma + lam c G_na G_mb into
    the sum), and per node pair G_n.G_m (2 dims - 1) and one
    multiply-add on each of its dims diagonal entries.  Poisson: c G_n
    once per node (dims nn) and a dims-term dot product into the sum
    per entry (2 dims)."""
    ndpe = nd * nn
    upper, pairs = ndpe * (ndpe + 1) // 2, nn * (nn + 1) // 2
    per = (2 * dims * dims * nn + (8 if dims == 2 else 42)
           + dims * (2 * dims - 1) * nn + 2)
    if nd > 1:
        per += 2 * dims * nn + 2 + 4 * upper + pairs * (4 * dims - 1)
    else:
        per += dims * nn + 2 * dims * upper
    return nelems * nq * per


def stiffness_pair(m, etype, physics, rho):
    """(kernel, plain, inputs): zero-argument calls of the element
    stiffness function that ``m.element_jacobian`` runs for ``etype`` and
    ``physics`` (K7a / K7b / K8) and of its plain version, on m's
    element coordinates and the RAMP material of ``rho`` (a tensor on
    m's device) in the kernels' layout, and those inputs."""
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3

    XeT, cqT = m._XeT, m._cq_transposed(rho)
    elastic = physics == "elasticity"
    args = (XeT, cqT, m.mu, m.lam) if elastic else (XeT, cqT)
    if etype == "quad4":
        fk, fp = ((ek.elasticity_stiffness_quad4,
                   ek.elasticity_stiffness_quad4_plain) if elastic else
                  (ek.poisson_stiffness_quad4,
                   ek.poisson_stiffness_quad4_plain))
        kw = {}
    else:
        fk, fp = ((ek3.elasticity_stiffness_3d,
                   ek3.elasticity_stiffness_3d_plain) if elastic else
                  (ek3.poisson_stiffness_3d, ek3.poisson_stiffness_3d_plain))
        kw = dict(etype=etype)
    return (lambda: fk(*args, **kw)), (lambda: fp(*args, **kw)), (XeT, cqT)


def ptxas_table(log):
    """{kernel symbol: "N registers, S/L bytes spill stores/loads"} from
    nvcc -Xptxas -v output."""
    table, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            parts = line.replace(",", "").split()
            spill = f"{parts[4]}/{parts[8]} B spill stores/loads"
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            table[name] = f"{regs} registers, {spill}"
            name = None
    return table


# (key, etype, ProblemCreator element_type, template tag in the symbol)
ELEM_FORMS = (
    ("K7a", "quad4", "quad", "stiffness_quad4_kernelILb1E"),
    ("K7b", "quad4", "quad", "stiffness_quad4_kernelILb0E"),
    ("K8 hex8 elasticity", "hex8", "block", "ILi8ELi8ELb1E"),
    ("K8 hex8 poisson", "hex8", "block", "ILi8ELi8ELb0E"),
    ("K8 tet10 elasticity", "tet10", "tet", "ILi10ELi5ELb1E"),
    ("K8 tet10 poisson", "tet10", "tet", "ILi10ELi5ELb0E"),
    ("K8 brick20 elasticity", "brick20", "brick20", "ILi20ELi27ELb1E"),
    ("K8 brick20 poisson", "brick20", "brick20", "ILi20ELi27ELb0E"),
)


def phase_kernels_elem(dev, pt, build_log):
    """Phase 3c: K7a, K7b and K8 against their plain versions on the
    card, on jittered meshes with p=3 and ``density``: quad4 at 1025x513
    and on the 17x9 / ragged 13x7 meshes, hex8 at 65^3, tet10 and
    brick20 on the 33^3 node lattice."""
    import torch

    regs = ptxas_table(build_log)
    sizes = {"quad4": [(NX, NY), (17, 9), (13, 7)], "hex8": [(N3,) * 3],
             "tet10": [(33,) * 3], "brick20": [(33,) * 3]}
    res = {}
    for key, etype, ctype, tag in ELEM_FORMS:
        physics = "poisson" if ("poisson" in key or key == "K7b") else \
            "elasticity"
        et = pt.get_element(etype)
        nd = et.ndims if physics == "elasticity" else 1
        worst = 0.0
        for i, dims in enumerate(sizes[etype]):
            conn, X, fixed, force = elem_problem(dims, ctype, SEED + 30 + i)
            m = pt.LinearElasticity(etype, X, conn, fixed, None, force,
                                    p=3.0, dtype=torch.float32, device=dev,
                                    kernel="cuda")
            rho = torch.as_tensor(density(etype, X, SEED + 31),
                                  dtype=torch.float32, device=dev)
            fk, fp, (XeT, cqT) = stiffness_pair(m, etype, physics, rho)
            got, ref = fk(), fp()
            torch.cuda.synchronize()
            ea, er = rel_err(got, ref)
            worst = max(worst, ea)
            tagd = f"{key} {'x'.join(map(str, dims))} ({m.nelems} elements)"
            log(f"{tagd}: rel {er:.2e} (abs {ea:.2e})")
            check(er <= REL_TOL, f"{tagd} within {REL_TOL:g}")
            check(torch.equal(got, fk()),
                  f"{tagd} repeat call bit-identical")
            if i:
                continue
            ms = cuda_ms(fk, 20)
            pms = cuda_ms(fp, 3)
            flops = stiffness_flops(et.nnodes, et.nquads, nd, et.ndims,
                                    m.nelems)
            b_ms, b_by = bound(nbytes(XeT, cqT, got), flops)
            reg = [v for k, v in regs.items() if tag in k]
            res[key] = dict(max_abs_err=ea, ms=ms, plain_ms=pms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            ptxas=reg[0] if reg else "not found",
                            bytes_ms=1e3 * nbytes(XeT, cqT, got) / HBM_BYTES_S,
                            flops_ms=1e3 * flops / F32_FLOP_S)
            log(f"{tagd}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}; bytes {res[key]['bytes_ms']:.4f} "
                f"ms, operations {res[key]['flops_ms']:.4f} ms at "
                f"{flops / 1e9:.2f} GFLOP), library none; ptxas "
                f"{res[key]['ptxas']}")
            del got, ref
        res[key]["max_abs_err"] = worst
    return res


def phase_kernels(dev):
    """Phase 3: each 2D kernel against its plain version on the card."""
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
            # per node: ~36 planes x 16 weights + 16 RAMP terms, 2 flops
            b_ms, b_by = bound(nbytes(rho, st.maskf, st.W, a.N, ck, dk, lk),
                               2 * (36 * 16 + 64) * rho.numel())
            res["K1"] = dict(max_abs_err=max(ea, ia),
                             ms=cuda_ms(lambda: fa.assemble_pack_2d(
                                 *args, **kw), 50),
                             plain_ms=cuda_ms(
                                 lambda: fa.assemble_pack_2d_plain(
                                     *args, **kw), 10),
                             bound_ms=b_ms, bound_by=b_by, library_ms=None)
            fine = (ck, dk, lk, st.mask)
    log(f"K1 {NX}x{NY}: kernel {res['K1']['ms']:.4f} ms, plain "
        f"{res['K1']['plain_ms']:.4f} ms, bound {res['K1']['bound_ms']:.4f} "
        f"ms ({res['K1']['bound_by']})")

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
            b_ms, b_by = bound(nbytes(ck, xr) + nbytes(xr),
                               2 * 72 * NX * NY)
            lib = library_matvec_ms(ck.reshape(2, 2, 3, 3, NY, NX),
                                    (NY, NX), xr)
            log(f"K2 matvec_f32: torch.sparse.mm (f32 CSR) {lib:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by})")
            res["K2"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib)
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


def phase_kernels_k9(dev):
    """Phase 3d: K9 against its plain version at 1025x513, 17x9 and 13x7:
    nd=1 (the Helmholtz filter's K planes) and nd=2 (the float64
    accuracy operator's elasticity planes), float32 and float64, with
    times, the bound and the CSR time at full size."""
    import torch
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    rng = np.random.default_rng(SEED + 9)
    forms, worst = {}, 0.0
    for nx, ny in ((NX, NY), (17, 9), (13, 7)):
        conn, X, _f, _l, (Lx, Ly) = problem(nx, ny)
        filt = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float64,
                            device=dev).attach_structured_grid(nx, ny)
        rho = torch.as_tensor(rng.uniform(0.3, 1.0, nx * ny), device=dev)
        c2 = f64_operator(nx, ny, Lx, Ly, rho, 3.0, dev)[2]
        for name, c in (("nd1_f32", filt._coeffK), ("nd1_f64", filt._coeffK),
                        ("nd2_f32", c2), ("nd2_f64", c2)):
            dt = torch.float32 if name.endswith("f32") else torch.float64
            c = c.to(dt).contiguous()
            nd = c.shape[0]
            u = torch.as_tensor(rng.standard_normal((nd, ny, nx)), dtype=dt,
                                device=dev)
            got = sm.stencil_matvec_2d(c, u)
            ref = sm.stencil_matvec_2d_plain(c, u)
            torch.cuda.synchronize()
            ea, er = rel_err(got, ref)
            worst = max(worst, ea)
            check(er <= REL_TOL and got.dtype == dt,
                  f"K9 {name} {nx}x{ny} within {REL_TOL:g} (rel {er:.2e})")
            if (nx, ny) != (NX, NY):
                continue
            b_ms, b_by = bound(nbytes(c, u, got), 2 * nd * nd * 9 * nx * ny,
                               F32_FLOP_S if dt == torch.float32
                               else F64_FLOP_S)
            forms[name] = dict(
                max_abs_err=ea,
                ms=cuda_ms(lambda: sm.stencil_matvec_2d(c, u), 50),
                plain_ms=cuda_ms(lambda: sm.stencil_matvec_2d_plain(c, u),
                                 10),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=library_matvec_ms(c, (ny, nx), u, dtype=dt))
            f = forms[name]
            log(f"K9 {name} {NX}x{NY}: rel {er:.2e}; kernel {f['ms']:.4f} ms, "
                f"plain {f['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"torch.sparse.mm ({str(dt)[6:]} CSR) {f['library_ms']:.4f} "
                f"ms")
    res = dict(forms["nd1_f32"], max_abs_err=worst, forms=forms)
    return {"K9": res}


def phase_kernels_sym2d(dev):
    """Phase 3e: K1-sym and K2-sym (half-symmetric 2D storage) against
    their plain versions at 1025x513, 17x9 and 13x7, nd=2 and nd=1, K2
    in every mode on f32 and bf16 planes, with times, bounds and the CSR
    matvec time at full size (nd=2)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    rng = np.random.default_rng(SEED + 10)
    res = {"K1-sym": dict(max_abs_err=0.0), "K2-sym": dict(max_abs_err=0.0)}
    for nx, ny in ((NX, NY), (17, 9), (13, 7)):
        for nd in (2, 1):
            full = (nx, ny) == (NX, NY) and nd == 2
            tag = f"{nx}x{ny} nd={nd}"
            a = multigrid.GMGAssembler(
                nx, ny, (nx - 1) / (ny - 1), 1.0,
                "elasticity" if nd == 2 else "poisson", p=3.0, device=dev,
                sym=True)
            st = a.static_levels[0]
            rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                                  dtype=torch.float32, device=dev)
            args = (rho, st.maskf, st.W, a.N)
            kw = dict(nd=nd, p=3.0, lp_dtype=torch.bfloat16, sym=True)
            ck, dk, lk = fa.assemble_pack_2d(*args, **kw)
            cp, dp, _ = fa.assemble_pack_2d_plain(*args, **kw)
            torch.cuda.synchronize()
            free = st.maskf > 0
            ea, er = rel_err(ck, cp)
            ia, ir = rel_err(dk, dp, free)
            res["K1-sym"]["max_abs_err"] = max(res["K1-sym"]["max_abs_err"],
                                               ea, ia)
            check(ck.shape[0] == len(fs.sym_planes_2d(nd)) and er <= REL_TOL
                  and ir <= REL_TOL and bool((dk[~free] == 0).all())
                  and torch.equal(lk, ck.to(torch.bfloat16)),
                  f"K1-sym {tag}: {ck.shape[0]} planes within {REL_TOL:g} "
                  f"(rel {er:.2e}), inv_diag (rel {ir:.2e}), bf16 copy")
            if full:
                b_ms, b_by = bound(
                    nbytes(rho, st.maskf, st.W, a.N, ck, dk, lk),
                    2 * (ck.shape[0] * 16 + 64) * rho.numel())
                res["K1-sym"].update(
                    ms=cuda_ms(lambda: fa.assemble_pack_2d(*args, **kw), 50),
                    plain_ms=cuda_ms(
                        lambda: fa.assemble_pack_2d_plain(*args, **kw), 10),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
                r = res["K1-sym"]
                log(f"K1-sym {tag}: kernel {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            field = lambda: torch.as_tensor(
                rng.standard_normal((nd, ny, nx)), dtype=torch.float32,
                device=dev)
            b = torch.where(st.mask, 0.0, field())
            x0 = torch.where(st.mask, 0.0, field())
            xr = field()
            om2 = multigrid.smoothing_omegas(2, 2.3 if nd == 2 else 1.6)
            variants = {
                "presmooth_resid_bf16": ((lk, dk, b, None), dict(
                    niter=2, want_resid=True, omega=om2)),
                "postsmooth_bf16": ((lk, dk, b, x0), dict(
                    niter=2, omega=om2[::-1])),
                "postsmooth_resid_f32": ((ck, dk, b, x0), dict(
                    niter=2, want_resid=True, omega=om2[::-1])),
                "resid_f32": ((ck, dk, b, xr), dict(niter=0,
                                                    want_resid=True)),
                "matvec_f32": ((ck, dk, None, xr), dict(
                    niter=0, want_resid=True, neg_resid=True)),
                "matvec_bf16": ((lk, dk, None, xr), dict(
                    niter=0, want_resid=True, neg_resid=True)),
            }
            for name, (va, vkw) in variants.items():
                got = fs.fused_sweeps_2d(*va, **vkw)
                ref = fs.fused_sweeps_2d_plain(*va, **vkw)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                errs = [rel_err(g, r) for g, r in zip(got, ref)]
                res["K2-sym"]["max_abs_err"] = max(
                    [res["K2-sym"]["max_abs_err"]] + [e[0] for e in errs])
                check(all(e[1] <= REL_TOL for e in errs),
                      f"K2-sym {name} {tag} within {REL_TOL:g} (rel "
                      + ", ".join(f"{e[1]:.2e}" for e in errs) + ")")
                if not full:
                    continue
                ms = cuda_ms(lambda: fs.fused_sweeps_2d(*va, **vkw), 50)
                pms = cuda_ms(lambda: fs.fused_sweeps_2d_plain(*va, **vkw),
                              10)
                log(f"K2-sym {name} {tag}: kernel {ms:.4f} ms, plain "
                    f"{pms:.4f} ms")
                if name == "matvec_f32":
                    b_ms, b_by = bound(nbytes(ck, xr) + nbytes(xr),
                                       2 * 72 * nx * ny)
                    lib = library_matvec_ms(fs.full_planes_2d(ck, 2),
                                            (ny, nx), xr)
                    log(f"K2-sym matvec_f32: bound {b_ms:.4f} ms ({b_by}), "
                        f"torch.sparse.mm (f32 CSR) {lib:.4f} ms")
                    res["K2-sym"].update(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=lib)
            kw8 = dict(niter=8, want_resid=True,
                       omega=multigrid.smoothing_omegas(8, 2.3))
            (xk, rk), (xp, rp) = (fs.fused_sweeps_2d(ck, dk, b, None, **kw8),
                                  fs.fused_sweeps_2d_plain(ck, dk, b, None,
                                                           **kw8))
            ex, rr = rel_err(xk, xp), rel_err(rk, rp)
            bmax = float(b.abs().max())
            check(ex[1] <= REL_TOL and rr[0] <= REL_TOL * bmax,
                  f"K2-sym niter8_cheby {tag}: x rel {ex[1]:.2e}, r "
                  f"{rr[0] / bmax:.2e} of max|b|")
    return res


def phase_kernels_3d(dev):
    """Phase 3a: K3, K4 and K5 against their plain versions on the card,
    in half-symmetric (``sym``) and full coefficient storage."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    rng = np.random.default_rng(SEED + 10)
    res = {}
    fine = {}
    for (nx, ny, nz), physics, sym in itertools.product(
        ((N3, N3, N3), (9, 7, 5)), ("elasticity", "poisson"), (True, False)
    ):
        a = multigrid.GMGAssembler3D(nx, ny, nz, (nx - 1) / (ny - 1), 1.0,
                                     (nz - 1) / (ny - 1), physics, p=3.0,
                                     device=dev)
        st, nd = a.static_levels[0], a.nd
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (nz, ny, nx)),
                              dtype=torch.float32, device=dev)
        args = (rho, st.maskf, st.W, a.N)
        kw = dict(nd=nd, p=3.0, lp_dtype=torch.bfloat16, sym=sym)
        ck, dk, lk = fa.assemble_pack_3d(*args, **kw)
        cp, dp, _ = fa.assemble_pack_3d_plain(*args, **kw)
        torch.cuda.synchronize()
        free = st.maskf > 0
        ea, er = rel_err(ck, cp)
        ia, ir = rel_err(dk, dp, free)
        form = "sym" if sym else "full"
        tag = f"K3 {form} {nx}x{ny}x{nz} nd={nd}"
        log(f"{tag}: {ck.shape[0]} planes rel {er:.2e} (abs {ea:.2e}), "
            f"inv_diag free rel {ir:.2e}")
        check(er <= REL_TOL, f"{tag} planes within {REL_TOL:g}")
        check(ir <= REL_TOL, f"{tag} inv_diag within {REL_TOL:g}")
        check(bool((dk[~free] == 0).all()), f"{tag} inv_diag 0 fixed")
        check(torch.equal(lk, ck.to(torch.bfloat16)),
              f"{tag} bf16 copy == its f32 planes rounded")
        if (nx, ny, nz, nd) == (N3, N3, N3, 3):
            # per node: ~2,300 (sym) / ~4,600 (full) weight FMAs over the
            # planes + 512 for the material at 64 quad points, 2 flops each
            fmas = 2300 if sym else 4608
            b_ms, b_by = bound(nbytes(rho, st.maskf, st.W, a.N, ck, dk, lk),
                               2 * (fmas + 512) * rho.numel())
            r = dict(
                max_abs_err=max(ea, ia),
                ms=cuda_ms(lambda: fa.assemble_pack_3d(*args, **kw), 20),
                plain_ms=cuda_ms(lambda: fa.assemble_pack_3d_plain(
                    *args, **kw), 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"K3 {form} {N3}^3: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            res["K3" if sym else "K3 full"] = r
            fine[form] = (ck, dk, lk, st.mask)

    mask = fine["sym"][3]
    shape = (3, N3, N3, N3)
    field = lambda: torch.as_tensor(rng.standard_normal(shape),
                                    dtype=torch.float32, device=dev)
    b = torch.where(mask, 0.0, field())
    x0 = torch.where(mask, 0.0, field())
    xr = field()
    n3 = N3 ** 3
    k4 = {}
    for form, (ck, dk, lk, _m) in fine.items():
        for cname, c in (("f32", ck), ("bf16", lk)):
            pre = f"{form}_{cname}"
            k4.update({
                f"sweep_{pre}": ((c, dk, b, x0), dict(mode="sweep",
                                                      omega=0.5)),
                f"resid_{pre}": ((c, None, b, x0), dict(mode="resid")),
                f"negresid_{pre}": ((c, None, b, x0),
                                    dict(mode="resid", neg_resid=True)),
                f"matvec_{pre}": ((c, None, None, xr),
                                  dict(mode="matvec", neg_resid=True)),
                f"negmatvec_{pre}": ((c, None, None, xr),
                                     dict(mode="matvec")),
            })
    worst = 0.0
    for name, (a, kw) in k4.items():
        got = fs.fused_sweep_3d(*a, **kw)
        ref = fs.fused_sweep_3d_plain(*a, **kw)
        torch.cuda.synchronize()
        ea, er = rel_err(got, ref)
        worst = max(worst, ea)
        log(f"K4 {name}: rel {er:.2e}")
        check(er <= REL_TOL, f"K4 {name} within {REL_TOL:g}")
    lib = library_matvec_ms(fs.full_planes_3d(fine["sym"][0], 3),
                            (N3, N3, N3), xr)
    for form in ("sym", "full"):
        a, kw = k4[f"matvec_{form}_f32"]
        ck = fine[form][0]
        # per node: one FMA per plane and neighbour: 243 either way
        b_ms, b_by = bound(nbytes(ck, xr) + nbytes(xr), 2 * 243 * n3)
        r = dict(
            max_abs_err=worst,
            ms=cuda_ms(lambda: fs.fused_sweep_3d(*a, **kw), 50),
            plain_ms=cuda_ms(lambda: fs.fused_sweep_3d_plain(*a, **kw), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        res["K4" if form == "sym" else "K4 full"] = r
        log(f"K4 matvec_{form}_f32 {N3}^3: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, torch.sparse.mm (f32 CSR) "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    ck, dk, lk, _m = fine["sym"]
    om2 = multigrid.smoothing_omegas(2, 3.0)
    k5 = {
        "presmooth_resid_bf16": ((lk, dk, b, None),
                                 dict(niter=2, want_resid=True, omega=om2)),
        "postsmooth_bf16": ((lk, dk, b, x0), dict(niter=2, omega=om2[::-1])),
        "full_presmooth_resid_bf16": ((fine["full"][2], fine["full"][1], b,
                                       None),
                                      dict(niter=2, want_resid=True,
                                           omega=om2)),
    }
    worst = 0.0
    for name, (a, kw) in k5.items():
        got = fs.fused_sweeps3d(*a, **kw)
        ref = fs.fused_sweeps3d_plain(*a, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        worst = max([worst] + [e[0] for e in errs])
        ms = cuda_ms(lambda: fs.fused_sweeps3d(*a, **kw), 20)
        pms = cuda_ms(lambda: fs.fused_sweeps3d_plain(*a, **kw), 3)
        log(f"K5 {name}: rel " + ", ".join(f"{e[1]:.2e}" for e in errs)
            + f"; kernel {ms:.4f} ms, plain {pms:.4f} ms")
        check(all(e[1] <= REL_TOL for e in errs),
              f"K5 {name} within {REL_TOL:g}")
        if name == "presmooth_resid_bf16":
            # the function reads the planes once; the per-sweep form
            # reads them halo_sweeps_3d(2, True, True) = 2 times
            b_ms, b_by = bound(nbytes(lk, dk, b) + 2 * nbytes(b),
                               2 * 243 * 2 * n3)
            res["K5"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None)
            log(f"K5 {name}: bound {b_ms:.4f} ms ({b_by}); stencil "
                f"passes {fs.halo_sweeps_3d(2, True, True)}")
    # nu=4 Chebyshev-node sweeps: the residual is damped below b, so its
    # rounding is measured against max|b| (as K2's niter=8 check)
    kw = dict(niter=4, want_resid=True,
              omega=multigrid.smoothing_omegas(4, 3.0))
    (xk, rk), (xp, rp) = (fs.fused_sweeps3d(lk, dk, b, x0, **kw),
                          fs.fused_sweeps3d_plain(lk, dk, b, x0, **kw))
    ex, rr = rel_err(xk, xp), rel_err(rk, rp)
    bmax = float(b.abs().max())
    log(f"K5 nu4_cheby_bf16: x rel {ex[1]:.2e}; r rel {rr[1]:.2e} of "
        f"max|r|, {rr[0] / bmax:.2e} of max|b|")
    check(ex[1] <= REL_TOL and rr[0] <= REL_TOL * bmax,
          f"K5 nu4_cheby x and r within {REL_TOL:g} (r of max|b|)")
    res["K5"]["max_abs_err"] = max(worst, ex[0], rr[0])
    return res


def k6_passes(lv, b, x, kw):
    """One K6 call's stencil passes one at a time, each beside the plain
    version fed the same input (the kernel's previous pass).

    Returns ([(name, kernel, plain, is_residual)], the last pass's kernel
    outputs).  Pass by pass, because with bf16 operands every pass
    rounds its iterate to bf16: a float32 summation-order difference of
    ~1e-7 in one pass can flip a rounding and move the next pass by a
    bf16 ulp, so a whole multi-pass call differs from its plain version
    by up to ~1e-4 although every pass agrees to float32 rounding.
    """
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d
    from pyfem_gpu_testflight_tpu_torch.ops.fused_smooth import _omega_seq

    args = (lv.rho, lv.maskf, lv.w3, lv.wd)
    common = dict(p=lv.p, mxu_bf16=kw.get("mxu_bf16", False))
    pairs = []
    for i, om in enumerate(_omega_seq(kw.get("omega", 0.6), kw["niter"])):
        one = dict(niter=1, want_resid=False, omega=om, **common)
        k = otf3d.otf_apply_3d(*args, b, x, **one)
        pairs.append((f"sweep {i}", k,
                      otf3d.otf_apply_3d_plain(*args, b, x, **one), False))
        x = k
    last = [x] if kw["niter"] else []
    if kw.get("want_resid", True):
        one = dict(niter=0, neg_resid=kw.get("neg_resid", False), **common)
        k = otf3d.otf_apply_3d(*args, b, x, **one)
        pairs.append(("residual", k,
                      otf3d.otf_apply_3d_plain(*args, b, x, **one), True))
        last.append(k)
    return pairs, last


def phase_kernels_otf(dev):
    """Phase 3b: K6 against its plain version on the card, pass by pass
    (``k6_passes``), and each whole call equal to its passes."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    rng = np.random.default_rng(SEED + 20)
    res = {}
    worst = 0.0
    for (nx, ny, nz), physics in (((N3, N3, N3), "elasticity"),
                                  ((9, 7, 5), "elasticity"),
                                  ((9, 7, 5), "poisson")):
        a = multigrid.GMGAssembler3D(nx, ny, nz, (nx - 1) / (ny - 1), 1.0,
                                     (nz - 1) / (ny - 1), physics, p=3.0,
                                     device=dev, elem_path="otf")
        nd = a.nd
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (nz, ny, nx)),
                              dtype=torch.float32, device=dev)
        _g, lv = a.assemble(rho)
        field = lambda: torch.as_tensor(rng.standard_normal((nd, nz, ny, nx)),
                                        dtype=torch.float32, device=dev)
        b = torch.where(lv.mask, 0.0, field())
        x0 = torch.where(lv.mask, 0.0, field())
        om2 = multigrid.smoothing_omegas(2, 3.0)
        calls = {"matvec_f32": ((None, x0), dict(niter=0, neg_resid=True))}
        for cname, bf in (("f32", False), ("bf16", True)):
            calls[f"presmooth_resid_{cname}"] = (
                (b, None), dict(niter=2, omega=om2, mxu_bf16=bf))
            calls[f"postsmooth_{cname}"] = (
                (b, x0), dict(niter=2, want_resid=False, omega=om2[::-1],
                              mxu_bf16=bf))
        calls["presmooth_resid_nu4_f32"] = (
            (b, None), dict(niter=4, omega=multigrid.smoothing_omegas(4, 3.0)))
        tag = f"K6 {nx}x{ny}x{nz} nd={nd}"
        for name, ((bb, xx), kw) in calls.items():
            kw = dict(kw, p=lv.p)
            args = (lv.rho, lv.maskf, lv.w3, lv.wd, bb, xx)
            got = otf3d.otf_apply_3d(*args, **kw)
            ref = otf3d.otf_apply_3d_plain(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            pairs, last = k6_passes(lv, bb, xx, kw)
            torch.cuda.synchronize()
            same = all(torch.equal(g, l) for g, l in zip(got, last))
            errs = []
            for pname, k, r, is_resid in pairs:
                d = float((k - r).abs().max())
                scale = float(r.abs().max())
                if is_resid and bb is not None:
                    # a residual after damping sweeps is rounded at b's
                    # scale (as K5's nu=4 check)
                    scale = max(scale, float(bb.abs().max()))
                worst = max(worst, d)
                errs.append(d / scale)
            whole = max(rel_err(g, r)[1] for g, r in zip(got, ref))
            log(f"{tag} {name}: per pass rel "
                + ", ".join(f"{e:.2e}" for e in errs)
                + f"; whole call vs plain {whole:.2e}; call == its passes "
                f"{same}")
            check(max(errs) <= REL_TOL, f"{tag} {name} within {REL_TOL:g}")
            check(same, f"{tag} {name} call equals its passes bit for bit")
        if (nx, ny, nz) != (N3, N3, N3):
            continue
        n3 = rho.numel()
        # per node: 512 weight FMAs per (ca, cb) pair (the structurally
        # nonzero ones), 27 nd^2 Y products, 64 for the material; 2 flops
        flops = 2 * (nd * nd * (512 + 27) + 64) * n3
        for name in ("matvec_f32", "presmooth_resid_bf16",
                     "postsmooth_bf16", "presmooth_resid_f32"):
            (bb, xx), kw = calls[name]
            kw = dict(kw, p=lv.p)
            args = (lv.rho, lv.maskf, lv.w3, lv.wd, bb, xx)
            ms = cuda_ms(lambda: otf3d.otf_apply_3d(*args, **kw), 20)
            pms = cuda_ms(lambda: otf3d.otf_apply_3d_plain(*args, **kw), 3)
            log(f"K6 {name} {N3}^3: kernel {ms:.4f} ms, plain {pms:.4f} ms")
            if name == "matvec_f32":
                b_ms, b_by = bound(nbytes(rho, lv.maskf, lv.w3, lv.wd, xx)
                                   + nbytes(xx), flops)
                # the yardstick: the same operator as an f32 CSR matvec
                full, _d = fa.assemble_pack_3d_plain(
                    rho, lv.maskf, a.static_levels[0].W, a.N, nd=nd, p=3.0,
                    sym=False)
                lib = library_matvec_ms(full.reshape(nd, nd, 3, 3, 3, *rho.shape),
                                        tuple(rho.shape), xx)
                del full
                res["K6"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib)
                log(f"K6 matvec_f32 {N3}^3: bound {b_ms:.4f} ms ({b_by}; "
                    f"{flops / 1e9:.2f} GFLOP, dense TPU count "
                    f"{2 * nd * (64 * 27 * nd + 64) * n3 / 1e9:.2f}), "
                    f"torch.sparse.mm (f32 CSR) {lib:.4f} ms")
    res["K6"]["max_abs_err"] = worst
    return res


def solve_and_measure(step, args, names, label):
    """Warm-up solve, then one solve with the named counts zeroed just
    before and read just after; returns (outputs, counts, ms)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    t0 = time.time()
    step(*args)  # first call: library and allocator warm-up
    torch.cuda.synchronize()
    log(f"{label}: first (cold) solve {1e3 * (time.time() - t0):.1f} ms "
        f"host clock")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _cuda.reset_launches()
    e0.record()
    out = step(*args)
    e1.record()
    e1.synchronize()
    counts = {k: _cuda.launches[k] for k in names}
    return out, counts, e0.elapsed_time(e1)


def chained_ms(step, rho, rhs, u, n_chain=10):
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n_chain):
        u = step(rho, rhs, u)[0]
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n_chain


def breakdown(label, step, args, asm, rho, b, single_ms):
    """Where one solve's time goes: CUDA-event times of the hierarchy
    assembly, the PCG solve, one V-cycle and one fine-level matvec, then
    one assemble+solve under ``torch.profiler``: the kernels' device
    time, the launches, and the device busy share of ``single_ms``.
    Returns the hierarchy-assembly milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pyfem_gpu_testflight_tpu_torch import multigrid

    def timed(fn, reps=1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1) / reps

    (gmg, lv0), asm_ms = timed(lambda: asm.assemble(rho))
    (_x, k, _rn), pcg_ms = timed(lambda: multigrid.pcg_gmg(
        gmg, lv0, b, rtol=1e-6, maxiter=200, flexible=True))
    _, vc_ms = timed(lambda: gmg.apply(b), 5)
    _, mv_ms = timed(lambda: lv0.matvec(b), 20)
    log(f"{label} breakdown (CUDA events): hierarchy assembly {asm_ms:.3f} "
        f"ms, PCG {pcg_ms:.3f} ms ({k} iterations), one V-cycle "
        f"{vc_ms:.3f} ms, one fine matvec {mv_ms:.4f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()

    def dev_us(row):
        return getattr(row, "self_device_time_total",
                       getattr(row, "self_cuda_time_total", 0.0))

    rows = [r for r in prof.key_averages() if dev_us(r) > 0]
    busy_ms = sum(dev_us(r) for r in rows) / 1e3
    if not rows:
        log(f"{label} profile: no device time recorded (busy share not "
            f"measured)")
        return asm_ms
    log(f"{label} profile: {sum(r.count for r in rows)} device activities "
        f"(kernels and copies) in one assemble+solve, device time "
        f"{busy_ms:.3f} ms = {100 * busy_ms / single_ms:.1f}% of the "
        f"unprofiled single-shot {single_ms:.3f} ms")
    for r in sorted(rows, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(r) / 1e3:9.3f} ms {r.count:6d}x  {r.key[:90]}")
    return asm_ms


def phase_main_2d(dev, pt, multigrid, i2p, p2i, label="bench 2D",
                  **route):
    """Phase 4 (4d with ``elem_path="cuda"``): the 2D bench configuration
    through the port."""
    import torch

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler(
        NX, NY, Lx, Ly, "elasticity", p=0.0, dtype=torch.float32,
        device=dev, nu_pre=2, nu_post=2, min_n=5, coarse_dense_max=4096,
        smoother_dtype=torch.bfloat16, omega="cheby", **route,
    )
    log(f"main path {label}: {model.ndof} dof, levels {asm.sizes}, route "
        f"{route or 'uniform (K1)'}")
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    rhs = model.compute_rhs()

    def step(rho, rhs, chain):
        rho = rho + 0.0 * chain[0]
        gmg, lv0 = asm.assemble(rho)
        b = torch.where(lv0.mask, 0.0, i2p(rhs, 2).reshape(2, NY, NX))
        x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                                     flexible=True)
        return p2i(x.reshape(-1), 2), k, rn, b, gmg

    (u, k, rn, b, gmg), counts, single_ms = solve_and_measure(
        step, (rho, rhs, rhs), ("pyfem_assemble_2d", "pyfem_smooth_2d",
                                "pyfem_assemble_2d_sym",
                                "pyfem_smooth_2d_sym",
                                "pyfem_elasticity_quad4"), label)
    log(f"{label}: {k} PCG iterations (JAX reference: 7), "
        f"||r||/||b|| {float(rn) / float(torch.linalg.norm(b)):.3e}, "
        f"launches {counts}, single-shot {single_ms:.3f} ms")
    check(k <= 8, f"{label} converges in <= 8 iterations")
    check(float(rn) <= 1e-6 * float(torch.linalg.norm(b)),
          f"{label} PCG residual <= rtol")
    check(bool(torch.isfinite(u).all()) and u.shape == (model.ndof,),
          f"{label} solution finite, shape (ndof,)")
    if route.get("sym"):
        check(counts["pyfem_assemble_2d_sym"] == len(gmg.levels)
              and counts["pyfem_smooth_2d_sym"] > 0
              and counts["pyfem_assemble_2d"] == 0
              and counts["pyfem_smooth_2d"] == 0,
              f"{label}: K1-sym once per level ({len(gmg.levels)}), K2-sym "
              f"launched, no full-storage K1/K2 launch")
    elif route.get("elem_path", "uniform") == "uniform":
        check(counts["pyfem_assemble_2d"] > 0 and counts["pyfem_smooth_2d"]
              > 0, "K1 and K2 launched")
    else:
        check(counts["pyfem_elasticity_quad4"] == len(gmg.levels)
              and counts["pyfem_assemble_2d"] == 0
              and counts["pyfem_smooth_2d"] > 0,
              f"{label}: K7a once per level ({len(gmg.levels)}), no K1, K2 "
              f"launched")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(rho, rhs, rhs)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    log(f"{label}: peak device memory of one assemble+solve {mem / 2**20:.1f} "
        f"MiB above the {base / 2**20:.1f} MiB allocated before it")
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho, 0.0, dev)
    x = i2p(u, 2).reshape(2, NY, NX)
    true, floor = residuals(mv64, mvabs, b, x)
    log(f"{label}: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f}); <= 1e-5: {true <= 1e-5}")
    check(true <= FLOOR_FACTOR * floor,
          f"{label} true residual <= {FLOOR_FACTOR:g} x float32 floor")
    xa, ka, rna = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    err = float(torch.linalg.norm(x.double() - xa) / torch.linalg.norm(xa))
    log(f"{label} float64 outer PCG, float32 kernel V-cycle: {ka} "
        f"iterations, true residual {true_a:.3e}; the float32 solve's "
        f"rel L2 error against it {err:.3e}")
    check(true_a <= 1e-5, f"{label} float64-outer true residual <= 1e-5")
    ch = chained_ms(step, rho, rhs, u)
    log(f"{label}: chained {ch:.3f} ms/solve over 10")
    asm_ms = breakdown(label, step, (rho, rhs, rhs), asm, rho, b, single_ms)
    return dict(counts=counts, single_ms=single_ms, ch=ch, u=u, k=k,
                mem=mem, asm_ms=asm_ms, true=true, floor=floor, err=err,
                nlevels=len(gmg.levels))


def phase_main_3d(dev, pt, multigrid, i2p, p2i, label="bench 3D",
                  full=True, **route):
    """Phases 4a-4c: the 3D bench configuration (bench.py run_3d) on
    the assembled route (4a), the on-the-fly route
    (``elem_path="otf"``, 4b) or full coefficient storage (``sym=False``,
    4c); ``full=False`` skips the chained time and the breakdown."""
    import torch

    n = N3
    conn, X, fixed, force, L = problem(n, n, n)
    model = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler3D(
        n, n, n, *L, "elasticity", p=0.0, dtype=torch.float32, device=dev,
        nu_pre=2, nu_post=2, min_n=3, coarse_dense_max=4096,
        smoother_dtype=torch.bfloat16, omega="cheby", **route,
    )
    log(f"main path {label}: {model.ndof} dof, levels {asm.sizes}, "
        f"route {route or 'assembled, sym storage'}")
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    rhs = model.compute_rhs()

    def step(rho, rhs, chain):
        rho = rho + 0.0 * chain[0]
        gmg, lv0 = asm.assemble(rho)
        b = torch.where(lv0.mask, 0.0, i2p(rhs, 3).reshape(3, n, n, n))
        x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                                     flexible=True)
        return p2i(x.reshape(-1), 3), k, rn, b, gmg

    names = ("pyfem_assemble_3d", "pyfem_sweep_3d", "pyfem_sweeps_3d",
             "pyfem_otf_3d")
    (u, k, rn, b, gmg), counts, single_ms = solve_and_measure(
        step, (rho, rhs, rhs), names, label)
    log(f"{label}: {k} PCG iterations (JAX reference: 7), "
        f"||r||/||b|| {float(rn) / float(torch.linalg.norm(b)):.3e}, "
        f"launches {counts}, single-shot {single_ms:.3f} ms")
    check(k <= 8, f"{label} converges in <= 8 iterations")
    check(float(rn) <= 1e-6 * float(torch.linalg.norm(b)),
          f"{label} PCG residual <= rtol")
    check(bool(torch.isfinite(u).all()) and u.shape == (model.ndof,),
          f"{label} solution finite, shape (ndof,)")
    # the solve's own peak device memory, above what was allocated before
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(rho, rhs, rhs)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    log(f"{label}: peak device memory of one assemble+solve {mem / 2**20:.1f} "
        f"MiB above the {base / 2**20:.1f} MiB allocated before it")
    mv64, mvabs, _ = f64_operator_3d(n, L, rho, 0.0, dev)
    x = i2p(u, 3).reshape(3, n, n, n)
    true, floor = residuals(mv64, mvabs, b, x)
    log(f"{label}: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f}); <= 1e-5: {true <= 1e-5}")
    check(true <= FLOOR_FACTOR * floor,
          f"{label} true residual <= {FLOOR_FACTOR:g} x float32 floor")
    xa, ka, _ = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    log(f"{label} float64 outer PCG, float32 kernel V-cycle: {ka} "
        f"iterations, true residual {true_a:.3e}")
    check(true_a <= 1e-5, f"{label} float64-outer true residual <= 1e-5")
    out = dict(counts=counts, single_ms=single_ms, u=u, k=k, mem=mem,
               ch=None, levels=[type(lv).__name__ for lv in gmg.levels])
    if full:
        out["ch"] = chained_ms(step, rho, rhs, u)
        log(f"{label}: chained {out['ch']:.3f} ms/solve over 10")
        breakdown(label, step, (rho, rhs, rhs), asm, rho, b, single_ms)
    return out


def phase_model(dev, pt, etype, dims, label, **gmg_options):
    """Phases 5 / 5a / 5b: ``LinearElasticity.solve(method="gmg")``."""
    import torch

    conn, X, fixed, force, _L = problem(*dims)
    nn = int(np.prod(dims))
    for rlabel, rho_m in (
        ("rho=0.6", 0.6),
        ("rho~U[0.3,1]",
         np.random.default_rng(SEED + 1).uniform(0.3, 1.0, nn)),
    ):
        m = pt.LinearElasticity(etype, X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
        m.attach_structured_grid(*dims, **gmg_options)
        t0 = time.time()
        um = m.solve(method="gmg", rho=rho_m, rtol=1e-6)
        torch.cuda.synchronize()
        st = m.last_solve_stats
        log(f"{label} LinearElasticity.solve gmg {rlabel}: {st['iters']} "
            f"iterations, ||r|| {st['resnorm']:.3e}, "
            f"{time.time() - t0:.3f} s")
        check(bool(torch.isfinite(um).all()) and um.shape == (m.ndof,),
              f"{label} model solve {rlabel} finite")


def bc_residuals(m64, Ke64, b, u):
    """(float64 true relative residual, float32 floor) of ``u`` on the
    Dirichlet-constrained system of ``m64`` (float64 element matrices
    ``Ke64``): ||b - A u|| / ||b|| and u32 || |A| |u| || / ||b||."""
    import torch

    mask = m64.bc.mask
    u64, b64 = u.to(torch.float64), b.to(torch.float64)
    Au = torch.where(mask, u64, m64.matvec(Ke64, torch.where(mask, 0.0, u64)))
    ua = u64.abs()
    Aa = torch.where(mask, ua, m64.matvec(Ke64.abs(),
                                          torch.where(mask, 0.0, ua)))
    bn = float(torch.linalg.norm(b64))
    return (float(torch.linalg.norm(b64 - Au)) / bn,
            2.0 ** -24 * float(torch.linalg.norm(Aa)) / bn)


def phase_general(dev, pt, label, physics, etype="hex8", dims=(N3,) * 3):
    """Phases 5c / 5d / 5e: ``LinearElasticity`` / ``LinearPoisson``
    (gfunc = 1) on a jittered mesh (hex8 at 65^3, or quad4 at 1025x513
    for 5e), ``kernel="cuda"``, float32, ``solve(method="cg",
    rho~U[0.3,1], rtol=1e-6)``: the general-mesh element path (K8 or K7
    -> matrix-free operator -> Jacobi-PCG).  The kernel's launches are
    those of one solve; afterwards the kernel is held against its plain
    version on that solve's inputs."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    key = ("pyfem_stiffness_3d" if etype != "quad4" else
           "pyfem_elasticity_quad4" if physics == "elasticity" else
           "pyfem_poisson_quad4")
    label = f"{label} {etype} {physics} {'x'.join(map(str, dims))}"
    mesh = elem_problem(dims, "quad" if etype == "quad4" else "block",
                        SEED + 40)
    rho = np.random.default_rng(SEED + 41).uniform(0.3, 1.0, len(mesh[1]))
    make = lambda dtype, kernel: make_model(  # noqa: E731
        pt, physics, etype, mesh, dtype, kernel, dev)
    m = make(torch.float32, "cuda")
    log(f"{label}: {m.ndof} dof, {m.nelems} elements, jittered mesh")
    ej_ms = cuda_ms(lambda: m.element_jacobian(rho), 5)
    out = {}
    for name in ("cuda", "cuda again", "einsum"):
        mm = make(torch.float32, "einsum") if name == "einsum" else m
        mm.solve(method="cg", rho=rho, rtol=0.5)  # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.time()
        u = mm.solve(method="cg", rho=rho, rtol=1e-6)
        torch.cuda.synchronize()
        st = dict(mm.last_solve_stats, seconds=time.time() - t0,
                  launches=_cuda.launches[key])
        out[name] = (u, st)
        log(f"{label} kernel={name.split()[0]}: {st['iters']} CG "
            f"iterations, {st['readbacks']} host read-backs, ||r|| "
            f"{st['resnorm']:.3e}, solve (element_jacobian + CG) "
            f"{1e3 * st['seconds']:.1f} ms host clock, {key} launches "
            f"{st['launches']}")
        if name == "einsum":
            del mm
    u, st = out["cuda"]
    ue, ste = out["einsum"]
    # the kernel against its plain version at the shape this path gives it
    fk, fp, _ = stiffness_pair(m, etype, physics, torch.as_tensor(
        rho, dtype=torch.float32, device=dev))
    got, ref = fk(), fp()
    err, rel_k = rel_err(got, ref)
    del got, ref
    log(f"{label}: {key} on this solve's inputs vs plain: rel {rel_k:.2e} "
        f"(abs {err:.2e})")
    check(rel_k <= REL_TOL, f"{label}: kernel within {REL_TOL:g} of plain "
          f"on the main path's inputs")
    # where a CG iteration goes: the matrix-free operator and its parts
    from pyfem_gpu_testflight_tpu_torch import assembly

    Ke = m.element_jacobian(rho)
    seg, cd = m.segments, m.conn_dof
    data = (Ke, cd, m.bc.mask, seg)
    fe = torch.bmm(Ke, u[cd].unsqueeze(-1))
    parts = {
        "bc_elem_matvec": cuda_ms(lambda: assembly.bc_elem_matvec(data, u),
                                  10),
        "gather u[conn_dof]": cuda_ms(lambda: u[cd], 10),
        "bmm (element products)": cuda_ms(
            lambda: torch.bmm(Ke, u[cd].unsqueeze(-1)), 10),
        "segment sum": cuda_ms(lambda: seg.sum(fe), 10),
    }
    del Ke, fe
    per_it = 1e3 * st["seconds"] / st["iters"]
    log(f"{label}: one CG iteration {per_it:.3f} ms (solve host time / "
        f"iterations); " + ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in parts.items()))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m.solve(method="cg", rho=rho, rtol=1e-6)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    m64 = make(torch.float64, "einsum")
    Ke64 = m64.element_jacobian(rho)
    b = m64.bc.constrain_rhs(m64.compute_rhs(), lambda v: m64.matvec(Ke64, v))
    true, floor = bc_residuals(m64, Ke64, b, u)
    true_e, floor_e = bc_residuals(m64, Ke64, b, ue)
    del Ke64, m64
    rel = float(torch.linalg.norm(u.double() - ue.double())
                / torch.linalg.norm(ue.double()))
    log(f"{label}: element_jacobian {ej_ms:.3f} ms (kernel + layout copy); "
        f"peak device memory of one solve {mem / 2**20:.1f} MiB above "
        f"{base / 2**20:.1f} MiB")
    log(f"{label}: float64 true residual kernel=cuda {true:.3e}, "
        f"kernel=einsum {true_e:.3e} (ratio {true / true_e:.2f}); float32 "
        f"floor {floor:.3e} / {floor_e:.3e}; iterations {st['iters']} vs "
        f"{ste['iters']}; solution rel L2 diff {rel:.3e}")
    check(st["resnorm"] <= 1e-6 * float(torch.linalg.norm(b)) * 1.0001,
          f"{label} converged at rtol 1e-6")
    check(st["launches"] == 1,
          f"{label}: {key} launched once per element_jacobian")
    check(true <= 2.0 * true_e,
          f"{label} true residual <= 2 x the einsum float32 solve's")
    check(abs(st["iters"] - ste["iters"]) <= 0.15 * ste["iters"],
          f"{label} iterations within 15% of the einsum float32 solve")
    check(torch.equal(u, out["cuda again"][0])
          and st["iters"] == out["cuda again"][1]["iters"],
          f"{label}: two solves bit-identical")
    check(st["readbacks"] <= st["iters"] // 16 + 1,
          f"{label}: <= 1 host read-back per 16 CG iterations")
    check(bool(torch.isfinite(u).all()) and u.shape == (m.ndof,),
          f"{label} solution finite, shape (ndof,)")
    return dict(st=st, ste=ste, ej_ms=ej_ms, mem=mem, true=true,
                true_e=true_e, floor=floor, parts=parts, err=err)


TOPO_WARMUP, TOPO_ITERS = 2, 20  # bench.py --topo-iters defaults to 40


def phase_topo(dev, pt, i2p):
    """Phase 7: topology optimization at the width of ``bench.py --config
    topo`` (bench.py:319-428): 1025x513 quad4 cantilever, p=3,
    Chebyshev-node nu=2, bf16 smoother copy, flexible PCG rtol 1e-6,
    Helmholtz r0=0.01 rtol 1e-6, ``DeviceTopo(fixed_volume=0.4)``;
    2 warm-up and 20 timed MMA iterations (the bench's 40 cut for
    time).  Reports s/iteration, the state and filter iteration counts,
    K1/K2/K9 launches and host read-backs per iteration, the CUDA-event
    times of an iteration's six stages, the device busy share and peak
    memory, the first iteration's float32 compliance against a
    float64-outer solve, and a 4-iteration run resumed at 2 against the
    uninterrupted one."""
    import torch
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    from pyfem_gpu_testflight_tpu_torch import solvers
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.opt import DeviceTopo

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    t0 = time.time()
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
    model.attach_structured_grid(NX, NY, nu_pre=2, nu_post=2, min_n=5,
                                 smoother_dtype=torch.bfloat16,
                                 omega="cheby")
    filtr = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float32,
                         rtol=1e-6, device=dev)
    filtr.attach_structured_grid(NX, NY)
    make = lambda: DeviceTopo(model, filtr, fixed_volume=0.4, rtol=1e-6,
                              maxiter=200)
    dt = make()
    torch.cuda.synchronize()
    log(f"topo: {model.ndof} state dof, {model.nnodes} design variables, "
        f"levels {model._gmg_asm.sizes}, set-up {time.time() - t0:.2f} s")
    t0 = time.time()
    dt.optimize(max_iterations=TOPO_WARMUP, verbose=False,
                log_every=TOPO_WARMUP)
    log(f"topo: {TOPO_WARMUP}-iteration warm-up {time.time() - t0:.2f} s")

    # the timed run: launches snapshotted at the end of every iteration
    names = ("pyfem_assemble_2d", "pyfem_smooth_2d", "pyfem_stencil_2d")
    snaps = []

    def snapshot(stage):
        if stage == "mma_update":
            snaps.append(dict({k: _cuda.launches[k] for k in names},
                              **solvers.readbacks))

    dt.mark = snapshot
    dt.history.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rb0 = dict(solvers.readbacks)
    log_every = TOPO_ITERS // 4
    _cuda.reset_launches()
    x, rho = dt.optimize(max_iterations=TOPO_ITERS, verbose=False,
                         log_every=log_every)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    dt.mark = None
    per_it = [{k: s_[k] - (snaps[i - 1][k] if i else 0) for k in names}
              for i, s_ in enumerate(snaps)]
    hist = dt.history
    cg = [h["cg_iters"] for h in hist]
    fi = [h["filter_iters"] for h in hist]
    objs = [h["obj"] for h in hist]
    # read-backs of the timed iterations: the state PCG's r.r per PCG
    # iteration, the filter's flag per 16 of its iterations, one stats
    # drain per log_every iterations
    rb = {k: snaps[-1][k] - rb0[k] for k in rb0}
    reads = rb["pcg"] + rb["cg"] + TOPO_ITERS // log_every
    log(f"topo: {TOPO_ITERS} timed MMA iterations (bench.py runs 40; cut "
        f"to {TOPO_ITERS} for the time limit) in {dt.elapsed:.3f} s, "
        f"{dt.s_per_iter:.4f} s/iteration (CUDA-synchronized; steady "
        f"{dt.steady_s_per_iter:.4f}); compliance {objs[0]:.6e} -> "
        f"{objs[-1]:.6e}, volume {float(model.volume(rho)):.5f}")
    log(f"topo: state PCG iterations {cg}")
    log(f"topo: filter PCG iterations (fwd, bwd) {fi}")
    log(f"topo: launches per iteration K1 {[p['pyfem_assemble_2d'] for p in per_it]}, "
        f"K2 {[p['pyfem_smooth_2d'] for p in per_it]}, K9 "
        f"{[p['pyfem_stencil_2d'] for p in per_it]}")
    log(f"topo: host read-backs {reads} in {TOPO_ITERS} iterations "
        f"({reads / TOPO_ITERS:.1f} per iteration: state PCG {rb['pcg']}, "
        f"filter {rb['cg']}, drains {TOPO_ITERS // log_every}); peak "
        f"device memory {mem / 2**20:.1f} MiB above the {base / 2**20:.1f} "
        f"MiB allocated before the run")
    check(len(hist) == TOPO_ITERS and all(np.isfinite(objs))
          and all(0 < c <= 200 for c in cg), "topo: 20 iterations, finite "
          "history, every state solve converged (drain checks each)")
    check(len(per_it) == TOPO_ITERS
          and all(p["pyfem_stencil_2d"] > 0 for p in per_it)
          and all(p["pyfem_assemble_2d"] == len(model._gmg_asm.sizes)
                  for p in per_it),
          "topo: K9 launched in every iteration, K1 once per level")

    # the six stages of an iteration (CUDA events between them), then
    # the same step under the profiler
    lb_v, ub_v = dt._init_state()[1:3]
    state, k = dt.state, TOPO_ITERS
    stage_ms, step_ms = {}, []
    for _ in range(3):
        events = []

        def record(stage):
            events.append((stage, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()

        dt.mark = record
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _st = dt._step(*state, k, lb_v, ub_v)
        k += 1
        torch.cuda.synchronize()
        prev = e0
        for stage, e in events:
            stage_ms.setdefault(stage, []).append(prev.elapsed_time(e))
            prev = e
        step_ms.append(e0.elapsed_time(prev))
    dt.mark = None
    log("topo: one iteration's stages (CUDA events, mean of 3): " + ", ".join(
        f"{st_} {np.mean(v):.3f} ms" for st_, v in stage_ms.items())
        + f"; whole iteration {np.mean(step_ms):.3f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _st = dt._step(*state, k, lb_v, ub_v)
        torch.cuda.synchronize()
    dev_us = lambda r: getattr(r, "self_device_time_total",
                               getattr(r, "self_cuda_time_total", 0.0))
    rows = [r for r in prof.key_averages() if dev_us(r) > 0]
    busy_ms = sum(dev_us(r) for r in rows) / 1e3
    if rows:
        log(f"topo profile: {sum(r.count for r in rows)} device activities "
            f"in one iteration, device time {busy_ms:.3f} ms = "
            f"{100 * busy_ms / np.mean(step_ms):.1f}% of the unprofiled "
            f"iteration's {np.mean(step_ms):.3f} ms")
        for r in sorted(rows, key=dev_us, reverse=True)[:8]:
            log(f"  {dev_us(r) / 1e3:9.3f} ms {r.count:6d}x  {r.key[:90]}")
    else:
        log("topo profile: no device time recorded (busy share not "
            "measured)")

    # the first iteration's float32 compliance against a float64-outer
    # solve of the same density
    x0 = torch.full((model.nnodes,), 0.95, dtype=torch.float32, device=dev)
    rho0 = torch.clamp(filtr.apply(x0), min=dt.rho_floor)
    gmg, lv0 = model._gmg_asm.assemble(rho0)
    b = torch.where(lv0.mask, 0.0,
                    i2p(model.compute_rhs(), 2).reshape(2, NY, NX))
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho0, 3.0, dev)
    xa, ka, _ = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    c64 = float(torch.dot(b.double().reshape(-1), xa.reshape(-1)))
    log(f"topo: first iteration compliance float32 {objs[0]:.8e}, "
        f"float64-outer ({ka} iterations, true residual {true_a:.2e}) "
        f"{c64:.8e}: rel diff {abs(objs[0] - c64) / abs(c64):.3e}")
    check(true_a <= 1e-5, "topo: float64-outer true residual <= 1e-5")

    # stop at 2, resume to 4: bit for bit the uninterrupted 4 iterations
    ck = Path("build") / "chip_smoke" / "topo_checkpoint.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    d_full = make()
    x4, _ = d_full.optimize(max_iterations=4, verbose=False, log_every=2)
    make().optimize(max_iterations=2, verbose=False, log_every=2,
                    checkpoint_path=str(ck))
    d_res = make()
    x4r, _ = d_res.optimize(max_iterations=4, verbose=False, log_every=2,
                            resume=str(ck))
    same = torch.equal(x4, x4r) and [h["obj"] for h in d_res.history] == [
        h["obj"] for h in d_full.history]
    log(f"topo: 4 iterations resumed at 2 vs uninterrupted: bit-identical "
        f"{same} (objectives {[h['obj'] for h in d_res.history]})")
    check(same, "topo: a run resumed at iteration 2 equals the "
          "uninterrupted run bit for bit")
    n_k9 = sum(p["pyfem_stencil_2d"] for p in per_it)
    return dict(s_per_iter=dt.s_per_iter, k9_launches=n_k9,
                k9_per_iter=n_k9 / TOPO_ITERS, mem=mem, cg=cg)


def phase_direct(dev, pt):
    """Phase 6b: host scipy direct solves against the card's CG on small
    jittered meshes (quad4 257x129 both models; tet10 and brick20 on a
    9^3 lattice, elasticity).  float64 einsum: CG (rtol 1e-12) vs direct
    by p^T u and relative L2.  float32: kernel="cuda" against
    kernel="einsum" by the float64 true residuals of their CG solves."""
    import torch

    for etype, ctype, dims, physics in (
        ("quad4", "quad", (257, 129), "elasticity"),
        ("quad4", "quad", (257, 129), "poisson"),
        ("tet10", "tet", (9, 9, 9), "elasticity"),
        ("brick20", "brick20", (9, 9, 9), "elasticity"),
    ):
        mesh = elem_problem(dims, ctype, SEED + 50)
        rho = density(etype, mesh[1], SEED + 51)
        label = f"6b {etype} {'x'.join(map(str, dims))} {physics}"
        make = lambda dtype, kernel: make_model(  # noqa: E731
            pt, physics, etype, mesh, dtype, kernel, dev)
        m64 = make(torch.float64, "einsum")
        u_cg = m64.solve(method="cg", rho=rho, rtol=1e-12)
        it = m64.last_solve_stats["iters"]
        u_d = m64.solve(method="direct", rho=rho).to(dev)
        p_vec = torch.as_tensor(np.random.RandomState(123).rand(m64.ndof),
                                device=dev)
        ptu = lambda v: float(p_vec @ v.double())  # noqa: E731
        rel_ptu = abs(ptu(u_cg) - ptu(u_d)) / abs(ptu(u_d))
        rel_l2 = float(torch.linalg.norm(u_cg - u_d) / torch.linalg.norm(u_d))
        log(f"{label} float64 einsum: card CG ({it} iterations, rtol "
            f"1e-12) vs host scipy direct: p^T u rel {rel_ptu:.3e}, u rel "
            f"L2 {rel_l2:.3e}")
        check(rel_ptu <= 1e-10, f"{label} float64 p^T u within 1e-10")
        check(rel_l2 <= 1e-6, f"{label} float64 u within 1e-6 (rel L2)")
        Ke64 = m64.element_jacobian(rho)
        b = m64.bc.constrain_rhs(m64.compute_rhs(),
                                 lambda v: m64.matvec(Ke64, v))
        res = {}
        for kernel in ("cuda", "einsum"):
            m = make(torch.float32, kernel)
            u = m.solve(method="cg", rho=rho, rtol=1e-6)
            res[kernel] = bc_residuals(m64, Ke64, b, u) + (
                m.last_solve_stats["iters"],
                float(torch.linalg.norm(u.double() - u_d)
                      / torch.linalg.norm(u_d)))
        (tc, fc, ic, lc), (te, fe, ie, le) = res["cuda"], res["einsum"]
        log(f"{label} float32 CG rtol 1e-6: kernel=cuda {ic} iterations, "
            f"true residual {tc:.3e}, u rel L2 vs direct {lc:.3e}; "
            f"kernel=einsum {ie} iterations, true residual {te:.3e}, u rel "
            f"L2 {le:.3e}; float32 floor {fc:.3e}")
        check(tc <= 2.0 * te, f"{label} float32 kernel=cuda true residual "
              f"<= 2 x kernel=einsum's")


def phase_scipy(dev, pt, multigrid, i2p, p2i, dims):
    """Phases 6 / 6a: p^T u against scipy's float64 sparse direct solve."""
    import scipy.sparse.linalg as spla
    import torch

    dim = len(dims)
    nd = dim
    shape = dims[::-1]
    label = "x".join(map(str, dims))
    conn, X, fixed, force, L = problem(*dims)
    nn = int(np.prod(dims))
    rho_s = np.random.default_rng(SEED + 2).uniform(0.3, 1.0, nn)
    m = pt.LinearElasticity("quad4" if dim == 2 else "hex8", X, conn, fixed,
                            None, force, p=3.0, dtype=torch.float32,
                            device=dev)
    m.attach_structured_grid(*dims)
    um = m.solve(method="gmg", rho=rho_s, rtol=1e-6)
    if dim == 2:
        op = lambda d: f64_operator(*dims, *L, torch.as_tensor(rho_s), 3.0, d)
        asm = multigrid.GMGAssembler(*dims, *L, "elasticity", p=3.0,
                                     device=dev)
    else:
        op = lambda d: f64_operator_3d(dims[0], L, torch.as_tensor(rho_s),
                                       3.0, d)
        asm = multigrid.GMGAssembler3D(*dims, *L, "elasticity", p=3.0,
                                       device=dev)
    mv64, mvabs, c64 = op("cpu")
    b = torch.where(m.bc.mask.cpu(), 0.0,
                    m.compute_rhs().cpu().to(torch.float64))
    bp = i2p(b, nd).reshape((nd,) + shape)
    K = scipy_csr(c64, shape)
    u_ref = p2i(torch.as_tensor(spla.spsolve(K, bp.reshape(-1).numpy())),
                nd).numpy()
    p_vec = np.random.RandomState(123).rand(m.ndof)
    ptu = lambda u: float(p_vec @ np.asarray(u, np.float64))
    rel = abs(ptu(um.cpu()) - ptu(u_ref)) / abs(ptu(u_ref))
    true, floor = residuals(mv64, mvabs, bp,
                            i2p(um.cpu(), nd).reshape((nd,) + shape))
    log(f"{label} float32 gmg: p^T u rel err vs scipy {rel:.3e}; true "
        f"residual {true:.3e} (floor {floor:.3e})")
    check(true <= FLOOR_FACTOR * floor,
          f"{label} true residual <= {FLOOR_FACTOR:g} x float32 floor")
    g32, _ = asm.assemble(torch.as_tensor(rho_s, dtype=torch.float32,
                                          device=dev))
    mv64d, _, _ = op(dev)
    xa, ka, _ = accuracy_solve(g32, mv64d, bp.to(dev))
    rel_a = abs(ptu(p2i(xa.reshape(-1), nd).cpu()) - ptu(u_ref)) / abs(
        ptu(u_ref))
    log(f"{label} float64 outer PCG ({ka} iterations): p^T u rel err vs "
        f"scipy {rel_a:.3e}")
    check(rel_a <= 1e-5, f"{label} p^T u within 1e-5 of scipy")


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )

    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # 2. build
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # 3, 3a, 3b. kernels vs plain
    kres = phase_kernels(dev)
    kres.update(phase_kernels_3d(dev))
    kres.update(phase_kernels_otf(dev))
    # 3c. element stiffness
    kres.update(phase_kernels_elem(dev, pt, _cuda.build_log))
    # 3d, 3e. the 2D stencil product and the half-symmetric 2D storage
    kres.update(phase_kernels_k9(dev))
    kres.update(phase_kernels_sym2d(dev))

    # 4, 4a, 4b, 4c, 4d. main paths
    m2 = phase_main_2d(dev, pt, multigrid, i2p, p2i)
    c2, s2, ch2 = m2["counts"], m2["single_ms"], m2["ch"]
    m3 = phase_main_3d(dev, pt, multigrid, i2p, p2i)
    check(all(m3["counts"][k] > 0 for k in (
        "pyfem_assemble_3d", "pyfem_sweep_3d", "pyfem_sweeps_3d")),
        "bench 3D: K3, K4 and K5 launched")
    mo = phase_main_3d(dev, pt, multigrid, i2p, p2i, "bench 3D otf",
                       elem_path="otf")
    co = mo["counts"]
    check(co["pyfem_otf_3d"] > 0 and co["pyfem_assemble_3d"] == 1,
          "bench 3D otf: K6 launched, K3 once (the coarsest level)")
    check(mo["levels"][:-1] == ["OTFLevel"] * (len(mo["levels"]) - 1),
          "bench 3D otf: every level but the coarsest is on the fly")
    check(mo["k"] <= 8 and abs(mo["k"] - m3["k"]) <= 2,
          "bench 3D otf: <= 8 iterations, within 2 of the assembled route")
    du = float((mo["u"] - m3["u"]).abs().max() / m3["u"].abs().max())
    log(f"bench 3D otf vs assembled: {mo['k']} vs {m3['k']} iterations, "
        f"solution rel diff {du:.3e}; peak memory {mo['mem'] / 2**20:.1f} "
        f"vs {m3['mem'] / 2**20:.1f} MiB; single-shot "
        f"{mo['single_ms']:.3f} vs {m3['single_ms']:.3f} ms, chained "
        f"{mo['ch']:.3f} vs {m3['ch']:.3f} ms/solve")
    check(du <= 5e-4, "bench 3D otf solution within 5e-4 of assembled")
    mf = phase_main_3d(dev, pt, multigrid, i2p, p2i, "bench 3D sym=False",
                       full=False, sym=False)
    check(mf["counts"]["pyfem_sweep_3d"] > 0
          and mf["counts"]["pyfem_sweeps_3d"] > 0,
          "bench 3D sym=False: K4 and K5 launched on full planes")
    log(f"bench 3D sym=False: {mf['k']} iterations, single-shot "
        f"{mf['single_ms']:.3f} ms, peak memory {mf['mem'] / 2**20:.1f} "
        f"MiB")
    m2c = phase_main_2d(dev, pt, multigrid, i2p, p2i,
                        "bench 2D elem_path=cuda", elem_path="cuda")
    check(m2c["k"] <= 8 and abs(m2c["k"] - m2["k"]) <= 1,
          "bench 2D elem_path=cuda: <= 8 iterations, within 1 of phase 4")
    du2 = float((m2c["u"] - m2["u"]).abs().max() / m2["u"].abs().max())
    log(f"bench 2D elem_path=cuda vs uniform: {m2c['k']} vs {m2['k']} "
        f"iterations, solution rel diff {du2:.3e} (max-abs; rel L2 errors "
        f"against the float64-outer solution {m2c['err']:.3e} vs "
        f"{m2['err']:.3e}); true residual "
        f"{m2c['true']:.3e} vs {m2['true']:.3e}; hierarchy assembly "
        f"{m2c['asm_ms']:.3f} vs {m2['asm_ms']:.3f} ms; single-shot "
        f"{m2c['single_ms']:.3f} vs {m2['single_ms']:.3f} ms, chained "
        f"{m2c['ch']:.3f} vs {m2['ch']:.3f} ms/solve; peak memory "
        f"{m2c['mem'] / 2**20:.1f} vs {m2['mem'] / 2**20:.1f} MiB")

    m2s = phase_main_2d(dev, pt, multigrid, i2p, p2i, "bench 2D sym",
                        sym=True)
    check(m2s["k"] <= 8 and abs(m2s["k"] - m2["k"]) <= 1,
          "bench 2D sym: <= 8 iterations, within 1 of phase 4")
    log(f"bench 2D sym vs full storage: {m2s['k']} vs {m2['k']} iterations; "
        f"true residual {m2s['true']:.3e} vs {m2['true']:.3e}; hierarchy "
        f"assembly {m2s['asm_ms']:.3f} vs {m2['asm_ms']:.3f} ms; "
        f"single-shot {m2s['single_ms']:.3f} vs {m2['single_ms']:.3f} ms, "
        f"chained {m2s['ch']:.3f} vs {m2['ch']:.3f} ms/solve; peak memory "
        f"{m2s['mem'] / 2**20:.1f} vs {m2['mem'] / 2**20:.1f} MiB")

    # 5, 5a, 5b. model entry point
    phase_model(dev, pt, "quad4", (NX, NY), "2D")
    phase_model(dev, pt, "hex8", (N3, N3, N3), "3D")
    phase_model(dev, pt, "hex8", (N3, N3, N3), "3D otf", elem_path="otf")
    # 5c, 5d. the general-mesh element path
    g5c = phase_general(dev, pt, "5c", "elasticity")
    g5d = phase_general(dev, pt, "5d", "poisson")
    g5e = phase_general(dev, pt, "5e", "poisson", "quad4", (NX, NY))

    # 6, 6a, 6b. scipy checks
    phase_scipy(dev, pt, multigrid, i2p, p2i, (257, 129))
    phase_scipy(dev, pt, multigrid, i2p, p2i, (17, 17, 17))
    phase_direct(dev, pt)

    # 7. topology optimization at the bench width
    topo = phase_topo(dev, pt, i2p)

    # summary
    src = "pyfem_gpu_testflight_tpu_torch/csrc/"
    tpu = "pyfem_gpu_testflight_tpu/ops/"
    c3 = m3["counts"]
    rows = (
        ("K1", "assemble_pack_2d", "assemble_2d.cu", "pallas_assemble.py:192",
         c2["pyfem_assemble_2d"], "full 36-plane storage, one pass"),
        ("K2", "fused_sweeps_2d", "smooth_2d.cu", "pallas_smooth.py:369",
         c2["pyfem_smooth_2d"], "one stencil pass per sweep"),
        ("K3", "assemble_pack_3d", "assemble_3d.cu", "pallas_assemble.py:584",
         c3["pyfem_assemble_3d"], "both storages, one pass: half-symmetric "
         "123 planes (timed, main path) and full 243 planes (full_form)"),
        ("K4", "fused_sweep_3d", "smooth_3d.cu", "pallas_smooth.py:697",
         c3["pyfem_sweep_3d"], "both bodies, one pass: _kernel3d_sym "
         "(timed, main path) and _kernel3d on full planes (full_form)"),
        ("K5", "fused_sweeps3d", "smooth_3d.cu", "pallas_smooth.py:972",
         c3["pyfem_sweeps_3d"], "per-sweep: one stencil pass per sweep "
         "and one for the residual (not the single-pass z-blocked form); "
         "reads either storage"),
        ("K6", "otf_apply_3d", "otf_3d.cu", "pallas_otf3d.py:265",
         co["pyfem_otf_3d"], "one stencil pass per launch, coefficients "
         "rebuilt per node from the density (main path: bench 3D otf)"),
        ("K7a", "elasticity_stiffness_quad4", "stiffness_2d.cu",
         "pallas_stiffness.py:163", m2c["counts"]["pyfem_elasticity_quad4"],
         "one thread per element, upper triangle mirrored (main path: "
         "4d, once per GMG level; timed at 1025x513 jittered)"),
        ("K7b", "poisson_stiffness_quad4", "stiffness_2d.cu",
         "pallas_stiffness.py:205", g5e["st"]["launches"],
         "one thread per element, upper triangle mirrored (main path: 5e "
         "LinearPoisson quad4 kernel='cuda' CG solve at 1025x513)"),
        ("K8", "elasticity_stiffness_3d / poisson_stiffness_3d",
         "stiffness_3d.cu", "pallas_stiffness3d.py:231",
         g5c["st"]["launches"],
         "thread per (element, row block): hex8 elasticity one row node "
         "(timed, main path 5c), hex8 Poisson the whole element, "
         "tet10/brick20 one row (forms)"),
    )
    cs = m2s["counts"]
    rows += (
        ("K1-sym", "assemble_pack_2d(sym=True)", "assemble_2d.cu",
         "pallas_assemble.py:192", cs["pyfem_assemble_2d_sym"],
         "half-symmetric storage, 19 of 36 planes (5 of 9 at nd=1), one "
         "pass (main path: bench 2D sym, once per level)"),
        ("K2-sym", "fused_sweeps_2d (sym planes)", "smooth_2d.cu",
         "pallas_smooth.py:369", cs["pyfem_smooth_2d_sym"],
         "half-symmetric storage, partner term by a shifted read, one "
         "stencil pass per sweep (main path: bench 2D sym)"),
        ("K9", "stencil_matvec_2d", "stencil_2d.cu", "pallas_stencil.py:56",
         topo["k9_launches"],
         "one thread per node, all nd outputs, f32 and f64 (main path: "
         f"topo, {TOPO_ITERS} MMA iterations; timed form nd=1 f32, the "
         "filter's)"),
    )
    kernels = []
    kres["K8"] = dict(kres["K8 hex8 elasticity"], max_abs_err=max(
        [v["max_abs_err"] for k, v in kres.items() if k.startswith("K8 ")]
        + [g5c["err"], g5d["err"]]))
    kres["K7b"]["max_abs_err"] = max(kres["K7b"]["max_abs_err"], g5e["err"])
    for key, name, source, replaces, launches, form in rows:
        r = kres[key]
        row = dict(
            name=name, route="cuda", source=src + source,
            replaces=tpu + replaces, launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=1e3 * r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], form=form,
        )
        if f"{key} full" in kres:
            f = kres[f"{key} full"]
            row["full_form"] = dict(
                max_abs_err=f["max_abs_err"], ms=f["ms"],
                plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                bound_by=f["bound_by"], library_ms=f["library_ms"],
                launches_sym_false_path=mf["counts"][
                    "pyfem_assemble_3d" if key == "K3" else "pyfem_sweep_3d"])
        if key == "K8":
            row["launches_5d"] = g5d["st"]["launches"]
            row["forms"] = {
                k[3:]: dict(max_abs_err=v["max_abs_err"], ms=v["ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                            bound_by=v["bound_by"], ptxas=v["ptxas"])
                for k, v in kres.items() if k.startswith("K8 ")}
        if key in ("K7a", "K7b", "K8"):
            row["ptxas"] = r["ptxas"]
        if key == "K9":
            row["launches_per_mma_iteration"] = topo["k9_per_iter"]
            row["forms"] = r["forms"]
        kernels.append(row)
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    log(f"topo: {topo['s_per_iter']:.4f} s per MMA iteration at "
        f"{NX}x{NY} ({card})")
    log(f"2D single-shot {s2:.3f} ms, chained {ch2:.3f} ms/solve; 3D "
        f"single-shot {m3['single_ms']:.3f} ms, chained {m3['ch']:.3f} "
        f"ms/solve; 3D otf single-shot {mo['single_ms']:.3f} ms, chained "
        f"{mo['ch']:.3f} ms/solve ({card})")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
