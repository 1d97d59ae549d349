"""PyTorch port: the CUDA kernels against their plain versions on the card.

K1 and K2 on a 65x33 level; K3, K4 (every mode, f32 and bf16 planes)
and K5 on a 17^3 level, in half-symmetric and full coefficient storage;
K6 on a 17^3 level in every mode with f32 and bf16 operands; K7 and K8
in every form (quad4, hex8, tet10, brick20; elasticity and Poisson) on
jittered meshes, the determinism of the matrix-free operator and of a
CG solve, ``kernel="cuda"`` never taking a plain version on a CUDA
tensor, the 2D ``elem_path="cuda"`` hierarchy against the uniform
one, K9 (nd 1 and 2, float32 and float64), K1-sym and K2-sym (every
mode) on 65x33, 17x9 and 13x7 grids, and three ``DeviceTopo``
iterations at 65x33 with a bit-for-bit resume (chip_smoke.py phases
3-3e and 7 hold them at full size).

Needs an NVIDIA Hopper card and nvcc; marked ``slow`` (deselected by the
CPU tier) and skipped where CUDA is absent.  Run on the card with:

    python -m pytest --noconftest -m slow tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest imports JAX, which an install of
the port alone lacks.)  Tolerance: 1e-5 of max|plain| — both sides
read identical float32 / bf16 inputs and differ only in summation order
and FMA contraction.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

NX, NY = 65, 33
TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def level(dev):
    from pyfem_gpu_testflight_tpu_torch import multigrid

    a = multigrid.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                               device=dev)
    st = a.static_levels[0]
    rng = np.random.default_rng(0)
    rho = torch.as_tensor(rng.uniform(0.2, 1.0, (NY, NX)),
                          dtype=torch.float32, device=dev)
    return a, st, rho, rng


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def test_k1_matches_plain_on_card(level):
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a, st, rho, _ = level
    args = (rho, st.maskf, st.W, a.N)
    n0 = _cuda.launches["pyfem_assemble_2d"]
    ck, dk, lk = fa.assemble_pack_2d(*args, nd=2, p=3.0,
                                     lp_dtype=torch.bfloat16)
    cp, dp = fa.assemble_pack_2d_plain(*args, nd=2, p=3.0)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_assemble_2d"] == n0 + 1
    free = st.maskf > 0
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert torch.equal(lk, ck.to(torch.bfloat16))


@pytest.mark.parametrize("variant", ["pre_bf16", "post_f32", "matvec"])
def test_k2_matches_plain_on_card(level, variant):
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    a, st, rho, rng = level
    ck, dk, lk = fa.assemble_pack_2d(rho, st.maskf, st.W, a.N, nd=2, p=3.0,
                                     lp_dtype=torch.bfloat16)
    f = lambda: torch.as_tensor(rng.standard_normal((2, NY, NX)),
                                dtype=torch.float32, device=rho.device)
    b = torch.where(st.mask, 0.0, f())
    x0 = torch.where(st.mask, 0.0, f())
    args, kw = {
        "pre_bf16": ((lk, dk, b, None), dict(niter=2, want_resid=True)),
        "post_f32": ((ck, dk, b, x0), dict(niter=3, want_resid=True)),
        "matvec": ((ck, dk, None, f()),
                   dict(niter=0, want_resid=True, neg_resid=True)),
    }[variant]
    got = fs.fused_sweeps_2d(*args, **kw)
    ref = fs.fused_sweeps_2d_plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


def test_cuda_wrappers_refuse_float64(level):
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a, st, rho, _ = level
    with pytest.raises(TypeError):
        fa.assemble_pack_2d(rho.double(), st.maskf.double(), st.W.double(),
                            a.N.double(), nd=2, p=3.0)


# -- 3D: K3, K4 (sym storage) and K5 at 17^3 --------------------------------

N3 = 17


@pytest.fixture(scope="module")
def level3d(dev):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a = multigrid.GMGAssembler3D(N3, N3, N3, 1.0, 1.0, 1.0, "elasticity",
                                 p=3.0, device=dev)
    st = a.static_levels[0]
    rng = np.random.default_rng(1)
    rho = torch.as_tensor(rng.uniform(0.2, 1.0, (N3, N3, N3)),
                          dtype=torch.float32, device=dev)
    planes = fa.assemble_pack_3d(rho, st.maskf, st.W, a.N, nd=3, p=3.0,
                                 lp_dtype=torch.bfloat16)
    f = lambda: torch.as_tensor(rng.standard_normal((3, N3, N3, N3)),
                                dtype=torch.float32, device=dev)
    fields = dict(b=torch.where(st.mask, 0.0, f()),
                  x0=torch.where(st.mask, 0.0, f()), xr=f())
    return a, st, rho, planes, fields


def test_k3_matches_plain_on_card(level3d):
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a, st, rho, _, _ = level3d
    args = (rho, st.maskf, st.W, a.N)
    n0 = _cuda.launches["pyfem_assemble_3d"]
    ck, dk, lk = fa.assemble_pack_3d(*args, nd=3, p=3.0,
                                     lp_dtype=torch.bfloat16)
    cp, dp = fa.assemble_pack_3d_plain(*args, nd=3, p=3.0)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_assemble_3d"] == n0 + 1
    free = st.maskf > 0
    assert ck.shape == (123, N3, N3, N3)
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert bool((dk[~free] == 0).all())
    assert torch.equal(lk, ck.to(torch.bfloat16))


@pytest.mark.parametrize("variant", ["sweep_f32", "resid_bf16",
                                     "negresid_f32", "matvec_f32",
                                     "negmatvec_bf16"])
def test_k4_matches_plain_on_card(level3d, variant):
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    _, _, _, (ck, dk, lk), fl = level3d
    name, prec = variant.rsplit("_", 1)
    c = ck if prec == "f32" else lk
    args, kw = {
        "sweep": ((c, dk, fl["b"], fl["x0"]), dict(mode="sweep", omega=0.5)),
        "resid": ((c, None, fl["b"], fl["x0"]), dict(mode="resid")),
        "negresid": ((c, None, fl["b"], fl["x0"]),
                     dict(mode="resid", neg_resid=True)),
        "matvec": ((c, None, None, fl["xr"]),
                   dict(mode="matvec", neg_resid=True)),
        "negmatvec": ((c, None, None, fl["xr"]), dict(mode="matvec")),
    }[name]
    n0 = _cuda.launches["pyfem_sweep_3d"]
    got = fs.fused_sweep_3d(*args, **kw)
    ref = fs.fused_sweep_3d_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_sweep_3d"] == n0 + 1
    assert _rel(got, ref) <= TOL


def test_k3_full_storage_matches_plain_on_card(level3d):
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a, st, rho, _, _ = level3d
    args = (rho, st.maskf, st.W, a.N)
    ck, dk, lk = fa.assemble_pack_3d(*args, nd=3, p=3.0,
                                     lp_dtype=torch.bfloat16, sym=False)
    cp, dp = fa.assemble_pack_3d_plain(*args, nd=3, p=3.0, sym=False)
    torch.cuda.synchronize()
    free = st.maskf > 0
    assert ck.shape == (243, N3, N3, N3)
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert torch.equal(lk, ck.to(torch.bfloat16))


@pytest.mark.parametrize("variant", ["sweep_f32", "resid_bf16",
                                     "negmatvec_f32", "k5_presmooth_bf16"])
def test_k4_k5_full_storage_match_plain_on_card(level3d, variant):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    a, st, rho, _, fl = level3d
    ck, dk, lk = fa.assemble_pack_3d(rho, st.maskf, st.W, a.N, nd=3, p=3.0,
                                     lp_dtype=torch.bfloat16, sym=False)
    name, prec = variant.rsplit("_", 1)
    c = ck if prec == "f32" else lk
    if name == "k5_presmooth":
        kw = dict(niter=2, want_resid=True,
                  omega=multigrid.smoothing_omegas(2, 3.0))
        got = fs.fused_sweeps3d(c, dk, fl["b"], None, **kw)
        ref = fs.fused_sweeps3d_plain(c, dk, fl["b"], None, **kw)
    else:
        args, kw = {
            "sweep": ((c, dk, fl["b"], fl["x0"]),
                      dict(mode="sweep", omega=0.5)),
            "resid": ((c, None, fl["b"], fl["x0"]), dict(mode="resid")),
            "negmatvec": ((c, None, None, fl["xr"]), dict(mode="matvec")),
        }[name]
        got = (fs.fused_sweep_3d(*args, **kw),)
        ref = (fs.fused_sweep_3d_plain(*args, **kw),)
    torch.cuda.synchronize()
    assert _rel(got[0], ref[0]) <= TOL
    if len(ref) > 1:
        err = float((got[1] - ref[1]).abs().max())
        assert err <= TOL * float(fl["b"].abs().max())


@pytest.mark.parametrize("variant", ["presmooth_resid_bf16", "postsmooth_bf16",
                                     "nu4_resid_f32"])
def test_k5_matches_plain_on_card(level3d, variant):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    _, _, _, (ck, dk, lk), fl = level3d
    b, x0 = fl["b"], fl["x0"]
    om2 = multigrid.smoothing_omegas(2, 3.0)
    args, kw = {
        "presmooth_resid_bf16": ((lk, dk, b, None),
                                 dict(niter=2, want_resid=True, omega=om2)),
        "postsmooth_bf16": ((lk, dk, b, x0), dict(niter=2, omega=om2[::-1])),
        "nu4_resid_f32": ((ck, dk, b, x0),
                          dict(niter=4, want_resid=True,
                               omega=multigrid.smoothing_omegas(4, 3.0))),
    }[variant]
    got = fs.fused_sweeps3d(*args, **kw)
    ref = fs.fused_sweeps3d_plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert _rel(got[0], ref[0]) <= TOL
    if len(ref) > 1:
        # the residual is damped below b: its rounding is at b's scale
        err = float((got[1] - ref[1]).abs().max())
        assert err <= TOL * float(b.abs().max())


# -- K6: the on-the-fly operator at 17^3 ------------------------------------


@pytest.fixture(scope="module")
def otf_levels(dev):
    from pyfem_gpu_testflight_tpu_torch import multigrid

    out = {}
    for physics in ("elasticity", "poisson"):
        a = multigrid.GMGAssembler3D(N3, N3, N3, 1.0, 1.0, 1.0, physics,
                                     p=3.0, device=dev, elem_path="otf")
        rng = np.random.default_rng(2)
        rho = torch.as_tensor(rng.uniform(0.3, 1.0, N3 ** 3),
                              dtype=torch.float32, device=dev)
        _, lv = a.assemble(rho)
        f = lambda: torch.as_tensor(rng.standard_normal((a.nd, N3, N3, N3)),
                                    dtype=torch.float32, device=dev)
        out[physics] = (lv, torch.where(lv.mask, 0.0, f()),
                        torch.where(lv.mask, 0.0, f()))
    return out


def _k6_passes(lv, b, x, kw):
    """One K6 call's stencil passes one at a time on the card, each
    beside the plain version fed the same input (the kernel's previous
    pass): [(kernel, plain, is_residual)], and the last pass's kernel
    outputs.

    Pass by pass, because with bf16 operands every pass rounds its
    iterate to bf16: a float32 summation-order difference of ~1e-7 in
    one pass can flip a rounding and move the next pass by a bf16 ulp.
    """
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d
    from pyfem_gpu_testflight_tpu_torch.ops.fused_smooth import _omega_seq

    args = (lv.rho, lv.maskf, lv.w3, lv.wd)
    common = dict(p=lv.p, mxu_bf16=kw["mxu_bf16"])
    pairs = []
    for om in _omega_seq(kw.get("omega", 0.6), kw["niter"]):
        one = dict(niter=1, want_resid=False, omega=om, **common)
        k = otf3d.otf_apply_3d(*args, b, x, **one)
        pairs.append((k, otf3d.otf_apply_3d_plain(*args, b, x, **one),
                      False))
        x = k
    last = [x] if kw["niter"] else []
    if kw.get("want_resid", True):
        one = dict(niter=0, neg_resid=kw.get("neg_resid", False), **common)
        k = otf3d.otf_apply_3d(*args, b, x, **one)
        pairs.append((k, otf3d.otf_apply_3d_plain(*args, b, x, **one),
                      True))
        last.append(k)
    return pairs, last


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("variant", ["matvec", "presmooth_resid",
                                     "postsmooth", "nu4_resid"])
@pytest.mark.parametrize("bf16", [False, True])
def test_k6_matches_plain_on_card(otf_levels, physics, variant, bf16):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    lv, b, x0 = otf_levels[physics]
    om2 = multigrid.smoothing_omegas(2, 3.0)
    (bb, xx), kw = {
        "matvec": ((None, x0), dict(niter=0, neg_resid=True)),
        "presmooth_resid": ((b, None), dict(niter=2, omega=om2)),
        "postsmooth": ((b, x0), dict(niter=2, want_resid=False,
                                     omega=om2[::-1])),
        "nu4_resid": ((b, x0), dict(niter=4,
                                    omega=multigrid.smoothing_omegas(4, 3.0))),
    }[variant]
    kw.update(p=lv.p, mxu_bf16=bf16)
    n0 = _cuda.launches["pyfem_otf_3d"]
    got = otf3d.otf_apply_3d(lv.rho, lv.maskf, lv.w3, lv.wd, bb, xx, **kw)
    torch.cuda.synchronize()
    passes = kw["niter"] + (1 if kw.get("want_resid", True) else 0)
    assert _cuda.launches["pyfem_otf_3d"] == n0 + passes
    got = got if isinstance(got, tuple) else (got,)
    pairs, last = _k6_passes(lv, bb, xx, kw)
    torch.cuda.synchronize()
    # the fused call is exactly its passes (one launch each, no atomics)
    assert all(torch.equal(g, l) for g, l in zip(got, last))
    for k, r, is_resid in pairs:
        scale = float(r.abs().max())
        if is_resid and bb is not None:
            # a residual after damping sweeps is rounded at b's scale
            scale = max(scale, float(bb.abs().max()))
        assert float((k - r).abs().max()) <= TOL * scale


# -- K7 / K8: element stiffness; the general-mesh CG path ----------------


def _jittered(creator_kw, seed, amp=0.03):
    """A ProblemCreator mesh with every node moved by amp * N(0, 1)."""
    from pyfem_gpu_testflight_tpu_torch import ProblemCreator

    c = ProblemCreator(**creator_kw)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    rng = np.random.default_rng(seed)
    return conn, X + amp * rng.standard_normal(X.shape), fixed, force


_STIFF_CASES = {
    # name: (etype, ProblemCreator kwargs)
    "quad4": ("quad4", dict(nnodes_x=17, nnodes_y=9)),
    "quad4_ragged": ("quad4", dict(nnodes_x=12, nnodes_y=7)),
    "hex8": ("hex8", dict(nnodes_x=9, nnodes_y=7, nnodes_z=5,
                          element_type="block")),
    "tet10": ("tet10", dict(nnodes_x=5, nnodes_y=5, nnodes_z=5,
                            element_type="tet")),
    "brick20": ("brick20", dict(nnodes_x=5, nnodes_y=5, nnodes_z=5,
                                element_type="brick20")),
}


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("case", sorted(_STIFF_CASES))
def test_k7_k8_match_plain_on_card(dev, case, physics):
    from pyfem_gpu_testflight_tpu_torch.elements import get_element
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3
    from pyfem_gpu_testflight_tpu_torch.ops import stiffness

    etype, kw = _STIFF_CASES[case]
    conn, X, _f, _l = _jittered(kw, seed=len(case))
    et = get_element(etype)
    rng = np.random.default_rng(7)
    Xe = torch.as_tensor(X[conn], dtype=torch.float32, device=dev)
    XeT = ek.transpose_xe(Xe)
    cq = torch.as_tensor(rng.uniform(0.3, 1.0, (et.nquads, len(conn))),
                         dtype=torch.float32, device=dev)
    mu, lam = stiffness.lame_params(10.0, 0.3, et.ndims)
    if etype == "quad4":
        name = ("pyfem_elasticity_quad4" if physics == "elasticity"
                else "pyfem_poisson_quad4")
        run = ((lambda f: f(XeT, cq, mu, lam)) if physics == "elasticity"
               else (lambda f: f(XeT, cq)))
        fns = ((ek.elasticity_stiffness_quad4,
                ek.elasticity_stiffness_quad4_plain)
               if physics == "elasticity" else
               (ek.poisson_stiffness_quad4, ek.poisson_stiffness_quad4_plain))
    else:
        name = "pyfem_stiffness_3d"
        if physics == "elasticity":
            run = lambda f: f(XeT, cq, mu, lam, etype=etype)
            fns = (ek3.elasticity_stiffness_3d,
                   ek3.elasticity_stiffness_3d_plain)
        else:
            run = lambda f: f(XeT, cq, etype=etype)
            fns = (ek3.poisson_stiffness_3d, ek3.poisson_stiffness_3d_plain)
    n0 = _cuda.launches[name]
    got = run(fns[0])
    ref = run(fns[1])
    torch.cuda.synchronize()
    assert _cuda.launches[name] == n0 + 1
    assert got.shape == ref.shape
    assert _rel(got, ref) <= TOL
    assert torch.equal(got, run(fns[0]))  # one thread per output: no atomics


def test_elem_matvec_and_cg_are_deterministic_on_card(dev):
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import assembly

    conn, X, fixed, force = _jittered(
        dict(nnodes_x=9, nnodes_y=9, nnodes_z=9, element_type="block"), 3)
    m = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float32, device=dev, kernel="cuda")
    rho = np.random.default_rng(4).uniform(0.3, 1.0, m.nnodes)
    Ke = m.element_jacobian(rho)
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(m.ndof),
                        dtype=torch.float32, device=dev)
    y1 = assembly.elem_matvec(Ke, m.conn_dof, u, m.ndof, m.segments)
    y2 = assembly.elem_matvec(Ke, m.conn_dof, u, m.ndof, m.segments)
    assert torch.equal(y1, y2)
    u1 = m.solve(method="cg", rho=rho, rtol=1e-6)
    s1 = dict(m.last_solve_stats)
    u2 = m.solve(method="cg", rho=rho, rtol=1e-6)
    assert torch.equal(u1, u2) and s1 == m.last_solve_stats
    assert s1["readbacks"] <= s1["iters"] // 16 + 1


def test_kernel_cuda_never_takes_the_plain_version(dev, monkeypatch):
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3

    def refuse(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for mod in (ek, ek3):
        for fn in [f for f in dir(mod) if f.endswith("_plain")]:
            monkeypatch.setattr(mod, fn, refuse)
    for etype, kw in (("quad4", dict(nnodes_x=9, nnodes_y=5)),
                      ("hex8", dict(nnodes_x=5, nnodes_y=5, nnodes_z=5,
                                    element_type="block"))):
        conn, X, fixed, force = _jittered(kw, 6)
        before = dict(_cuda.launches)
        m = pt.LinearElasticity(etype, X, conn, fixed, None, force,
                                dtype=torch.float32, device=dev,
                                kernel="cuda")
        m.element_jacobian(0.5)
        mp = pt.LinearPoisson(etype, X, conn, fixed[::m.ndims] // m.ndims,
                              dtype=torch.float32, device=dev,
                              kernel="cuda")
        mp.element_jacobian(0.5)
        names = (("pyfem_elasticity_quad4", "pyfem_poisson_quad4")
                 if etype == "quad4" else ("pyfem_stiffness_3d",))
        assert sum(_cuda.launches[n] - before[n] for n in names) == 2


def test_gmg_elem_path_cuda_matches_uniform_on_card(dev):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    rho = torch.as_tensor(np.random.default_rng(8).uniform(0.3, 1.0, NY * NX),
                          dtype=torch.float32, device=dev)
    levels = {}
    n0 = _cuda.launches["pyfem_elasticity_quad4"]
    for ep in ("uniform", "cuda"):
        a = multigrid.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                                   device=dev, elem_path=ep)
        levels[ep] = a.assemble(rho)[0].levels
    assert (_cuda.launches["pyfem_elasticity_quad4"] - n0
            == len(levels["cuda"]))
    for lc, lu in zip(levels["cuda"], levels["uniform"]):
        assert _rel(lc.coeff, lu.coeff) <= TOL


# -- K9 (2D stencil product), K1-sym / K2-sym (half-symmetric 2D storage)
# and the device topology loop ---------------------------------------------


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(NY, NX), (9, 17), (7, 13)])
def test_k9_matches_plain_on_card(dev, nd, dtype, shape):
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    rng = np.random.default_rng(3)
    ny, nx = shape
    c = torch.as_tensor(rng.standard_normal((nd, nd, 3, 3, ny, nx)),
                        dtype=dtype, device=dev)
    u = torch.as_tensor(rng.standard_normal((nd, ny, nx)), dtype=dtype,
                        device=dev)
    n0 = _cuda.launches["pyfem_stencil_2d"]
    got = sm.stencil_matvec_2d(c, u)
    ref = sm.stencil_matvec_2d_plain(c, u)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_stencil_2d"] == n0 + 1
    assert got.dtype == dtype and _rel(got, ref) <= TOL


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", [(NY, NX), (9, 17), (7, 13)])
def test_k1_sym_matches_plain_on_card(dev, nd, shape):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    ny, nx = shape
    a = multigrid.GMGAssembler(nx, ny, 2.0, 1.0,
                               "elasticity" if nd == 2 else "poisson",
                               p=3.0, device=dev)
    st = a.static_levels[0]
    rho = torch.as_tensor(np.random.default_rng(4).uniform(0.2, 1.0, shape),
                          dtype=torch.float32, device=dev)
    args = (rho, st.maskf, st.W, a.N)
    kw = dict(nd=nd, p=3.0, lp_dtype=torch.bfloat16, sym=True)
    n0 = _cuda.launches["pyfem_assemble_2d_sym"]
    ck, dk, lk = fa.assemble_pack_2d(*args, **kw)
    cp, dp, _ = fa.assemble_pack_2d_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_assemble_2d_sym"] == n0 + 1
    assert ck.shape[0] == (19 if nd == 2 else 5)
    free = st.maskf > 0
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert torch.equal(lk, ck.to(torch.bfloat16))


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("variant", ["pre_bf16", "post_f32", "matvec",
                                     "resid_f32"])
@pytest.mark.parametrize("shape", [(NY, NX), (7, 13)])
def test_k2_sym_matches_plain_on_card(dev, nd, variant, shape):
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    ny, nx = shape
    a = multigrid.GMGAssembler(nx, ny, 2.0, 1.0,
                               "elasticity" if nd == 2 else "poisson",
                               p=3.0, device=dev)
    st = a.static_levels[0]
    rng = np.random.default_rng(5)
    rho = torch.as_tensor(rng.uniform(0.2, 1.0, shape), dtype=torch.float32,
                          device=dev)
    ck, dk, lk = fa.assemble_pack_2d(rho, st.maskf, st.W, a.N, nd=nd, p=3.0,
                                     lp_dtype=torch.bfloat16, sym=True)
    f = lambda: torch.where(st.mask, 0.0, torch.as_tensor(
        rng.standard_normal((nd, ny, nx)), dtype=torch.float32, device=dev))
    b, x0 = f(), f()
    om = multigrid.smoothing_omegas(2, 2.3)
    args, kw = {
        "pre_bf16": ((lk, dk, b, None), dict(niter=2, want_resid=True,
                                             omega=om)),
        "post_f32": ((ck, dk, b, x0), dict(niter=2, omega=om[::-1])),
        "matvec": ((ck, dk, None, x0), dict(niter=0, want_resid=True,
                                            neg_resid=True)),
        "resid_f32": ((ck, dk, b, x0), dict(niter=0, want_resid=True)),
    }[variant]
    n0 = _cuda.launches["pyfem_smooth_2d_sym"]
    got = fs.fused_sweeps_2d(*args, **kw)
    ref = fs.fused_sweeps_2d_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_smooth_2d_sym"] > n0
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


def test_device_topo_runs_on_card_and_resumes_bit_for_bit(dev, tmp_path):
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    nx, ny = 65, 33
    c = pt.ProblemCreator(nnodes_x=nx, nnodes_y=ny, element_type="quad")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float32, device=dev)
    m.attach_structured_grid(nx, ny, omega="cheby",
                             smoother_dtype=torch.bfloat16)
    f = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float32,
                     rtol=1e-6, device=dev)
    f.attach_structured_grid(nx, ny)

    def run(n, **kw):
        d = pt.opt.DeviceTopo(m, f, fixed_volume=0.4)
        x, _ = d.optimize(max_iterations=n, verbose=False, log_every=1,
                          **kw)
        return d, x

    _cuda.reset_launches()
    d3, x3 = run(3)
    assert _cuda.launches["pyfem_stencil_2d"] >= 3
    assert _cuda.launches["pyfem_assemble_2d"] == 3 * len(
        m._gmg_asm.static_levels)
    assert all(np.isfinite(h["obj"]) for h in d3.history)
    ck = str(tmp_path / "ck.npz")
    run(2, checkpoint_path=ck)
    d_r, x_r = run(3, resume=ck)
    assert torch.equal(x_r, x3)
    assert [h["obj"] for h in d_r.history] == [h["obj"] for h in d3.history]
