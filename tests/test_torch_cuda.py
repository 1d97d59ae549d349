"""PyTorch port: the CUDA kernels against their plain versions on the card.

K1 and K1-sym on every level of bench 2D (1025x513..9x5) and on ragged
grids down to 3x3, nd 2 and 1; K2 (full storage, every call form, niter
0-8, f32 and bf16 planes) and K9 on the same levels and ragged grids,
one launch per K2 call up to the sweep budget; K3, K4 (every mode,
f32 and bf16 planes) and K5 on a 17^3 level, in half-symmetric and full
coefficient storage;
K3 on every level of bench 3D (65^3..3^3) and on ragged and wide grids,
both storages, nd 3 and 1; K8 on a ragged last element group and one
element in every form, and ``element_jacobian(kernel="cuda")`` handing
out K8's buffer with no layout copy;
K6 on a 17^3 level in every mode with f32 and bf16 operands; K5 (nu =
1..4, from x0 = 0 or a given x, with and without the residual) and K6's
tensor-core pass on a ragged 9x7x5 grid, nd=3 and nd=1; K7 and K8
in every form (quad4, hex8, tet10, brick20; elasticity and Poisson) on
jittered meshes, the determinism of the matrix-free operator and of a
CG solve, ``kernel="cuda"`` never taking a plain version on a CUDA
tensor, the 2D ``elem_path="cuda"`` hierarchy against the uniform
one, K2-sym as K2 (each call with a sweep one launch, equal to the step
kernel's chain bit for bit; planes framed by NaN change nothing), and
three ``DeviceTopo``
iterations at 65x33 with a bit-for-bit resume; K1 nd=1 on the Newton
coefficient field c = h(1 + u^2) >= 1 on every level, K9 nd=1 on the
nonsymmetric Newton tangent planes (float32) and the float64 flux, and
the fused gmg Newton at 65^2; p-multigrid at 17^3 (tet10, brick20: K3
and K5 launched, against a float64 plain-version solve), its lattice
matvec bit-identical across two applies, and one ``smoother="chebyshev"``
V-cycle (2D, 3D, 3D on the fly) against its plain version; K4 at nd=1 on
the 3D filter's full-storage planes, three 3D ``DeviceTopo`` iterations at
17x9x9 against the same run on the CPU, and complex-step element
matrices on the card against the CPU's; U1 (CSR) on ragged rows at
every lanes-per-row group and U2 (DIA) with offsets past both ends, over
a shared-memory chunk, masked and not, float32 and float64, and AMG-PCG
on the 12x80 torque arm against the CPU; the float32 post-processing of
a GMG solution (strains, stresses, nodal strains) against float64 on the
same u, the nodal sums bit-identical across two runs
(chip_smoke.py phases 3-3e and 7-12 hold them at full size).

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


# K1 / K1-sym grids (nx, ny): bench 2D's levels 1025x513..9x5 (nx and ny
# odd, so every plane starts at another alignment); the tile form
# (nd = 1, and below 65536 nodes): 3x3, even widths (4x3, 66x9), a row of
# exactly one tile of 32 node pairs (64x5), one pair past it (66x9,
# 130x7), a lone node closing each row (13x7, 2049x3), a tall strip
# (3x600); the window form (nd = 2 from 65536 nodes) on ragged grids: an
# even width (1000x70), odd and prime sizes (331x211), rows of 40000
# nodes (40000x2) and rows of 3 (3x30000, a block spans 86 rows)
_K1_GRIDS = [((1024 >> i) + 1, (512 >> i) + 1) for i in range(8)] + [
    (3, 3), (4, 3), (13, 7), (64, 5), (66, 9), (130, 7), (2049, 3),
    (3, 600), (1000, 70), (331, 211), (40000, 2), (3, 30000)]


def _k1_case(dev, shape, nd, sym):
    """K1 in one storage: one launch, planes and free inverse diagonal
    within 1e-5 of max|plain|, 0 at fixed dofs, the bf16 copy its f32
    planes rounded, a repeat call bit-identical."""
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nx, ny = shape
    a = multigrid.GMGAssembler(nx, ny, 2.0, 1.0,
                               "elasticity" if nd == 2 else "poisson",
                               p=3.0, device=dev, min_n=nx + ny)
    st = a.static_levels[0]
    rho = torch.as_tensor(np.random.default_rng(4).uniform(
        0.2, 1.0, (ny, nx)), dtype=torch.float32, device=dev)
    args = (rho, st.maskf, st.W, a.N)
    kw = dict(nd=nd, p=3.0, lp_dtype=torch.bfloat16, sym=sym)
    name = "pyfem_assemble_2d_sym" if sym else "pyfem_assemble_2d"
    n0 = _cuda.launches[name]
    ck, dk, lk = fa.assemble_pack_2d(*args, **kw)
    cp, dp, _ = fa.assemble_pack_2d_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launches[name] == n0 + 1
    assert ck.shape == cp.shape
    assert ck.shape[0] == (len(fs.sym_planes_2d(nd)) if sym else nd * nd * 9)
    free = st.maskf > 0
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert bool((dk[~free] == 0).all())
    assert torch.equal(lk, ck.to(torch.bfloat16))
    again = fa.assemble_pack_2d(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (ck, dk, lk)))


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", _K1_GRIDS)
def test_k1_matches_plain_on_card(dev, nd, shape):
    _k1_case(dev, shape, nd, sym=False)


# K2 and K9 grids (nx, ny): bench 2D's levels and ragged ones down to 3x3,
# rows of 40000 and of 2 nodes
_K2_GRIDS = [((1024 >> i) + 1, (512 >> i) + 1) for i in range(8)] + [
    (3, 3), (13, 7), (17, 9), (40000, 2), (2, 3000)]


def _k2_calls(ck, lk, b, x0):
    """Every form of a K2 call: f32 and bf16 planes, niter 0-8, from x0 = 0
    and from x0, with and without the residual (either sign), and the
    matvec (niter 0, b = 0): (planes, b, x, kwargs, reference).  Damping:
    Chebyshev nodes, held against the plain version up to 4 sweeps and,
    from 5, bit for bit against the step kernel's chain (there the late
    nodes' large factors carry the plain version's own float32 rounding
    past 1e-5 of its scale: ``chip_smoke.py --k2-witness`` measures each
    float32 form against float64); from 5 sweeps also the stationary 0.7
    against the plain version."""
    from pyfem_gpu_testflight_tpu_torch import multigrid

    for planes in (ck, lk):
        yield planes, None, x0, dict(niter=0, want_resid=True,
                                     neg_resid=True), "plain"
        yield planes, b, x0, dict(niter=0, want_resid=True), "plain"
        for niter in range(1, 9):
            cheby = multigrid.smoothing_omegas(niter, 2.3)
            damping = ([(cheby, "plain")] if niter <= 4 else
                       [(cheby, "steps"), (0.7, "plain")])
            for om, held in damping:
                for x, want, neg in ((None, True, False), (x0, False, False),
                                     (x0, True, True), (None, False, False)):
                    yield planes, b, x, dict(niter=niter, want_resid=want,
                                             neg_resid=neg, omega=om), held


def _k2_step_chain(planes, dk, b, x, kw):
    """A K2 call by the step kernel: one ``pyfem_smooth_2d[_sym]`` launch a
    sweep (from x0 = 0 the first is elementwise) and one for the
    residual."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nd, ny, nx = dk.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    entry = ("pyfem_smooth_2d" if fs.is_full_storage_2d(planes, nd)
             else "pyfem_smooth_2d_sym")

    def step(xin, om, mode):
        out = torch.empty_like(dk)
        _cuda.launch(entry, planes.data_ptr(),
                     int(planes.dtype == torch.bfloat16), dk.data_ptr(),
                     ptr(b), ptr(xin), out.data_ptr(), nd, ny, nx,
                     float(om), mode, _cuda.stream_ptr(dk))
        return out

    for om in fs._omega_seq(kw["omega"], kw["niter"]):
        x = step(x, om, 0)
    r = (step(x, 0.0, 2 if kw["neg_resid"] else 1) if kw["want_resid"]
         else None)
    return fs._outputs(x, r, kw["niter"], kw["want_resid"])


def _nan_framed(t):
    """``t`` copied into a NaN-filled buffer, 64 bytes in: what a staged
    chunk reads past the planes' ends is NaN."""
    buf = torch.full((t.numel() + 128 // t.element_size(),), float("nan"),
                     dtype=t.dtype, device=t.device)
    off = 64 // t.element_size()
    v = buf[off:off + t.numel()].view(t.shape)
    v.copy_(t)
    return v


def _k2_case(dev, shape, nd, sym):
    """K2 in one storage in every call form (:func:`_k2_calls`): within
    1e-5 of max|plain| (a residual of max|b| where that is larger) or
    equal to the step kernel's chain, a repeat call and a call on the
    planes framed by NaN bit-identical, one launch per call up to the
    sweep budget (one per sweep group past it).  On half storage every
    call with a sweep equals the step kernel's chain bit for bit."""
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nx, ny = shape
    a = multigrid.GMGAssembler(nx, ny, 2.0, 1.0,
                               "elasticity" if nd == 2 else "poisson",
                               p=3.0, device=dev, min_n=nx + ny)
    st = a.static_levels[0]
    rng = np.random.default_rng(6)
    rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                          dtype=torch.float32, device=dev)
    ck, dk, lk = fa.assemble_pack_2d(rho, st.maskf, st.W, a.N, nd=nd, p=3.0,
                                     lp_dtype=torch.bfloat16, sym=sym)
    assert ck.shape[0] == (len(fs.sym_planes_2d(nd)) if sym else nd * nd * 9)
    f = lambda: torch.where(st.mask, 0.0, torch.as_tensor(
        rng.standard_normal((nd, ny, nx)), dtype=torch.float32, device=dev))
    b, x0 = f(), f()
    step, sweeps = (("pyfem_smooth_2d_sym", "pyfem_sweeps_2d_sym") if sym
                    else ("pyfem_smooth_2d", "pyfem_sweeps_2d"))
    for planes, bb, x, kw, held in _k2_calls(ck, lk, b, x0):
        n0 = dict(_cuda.launches)
        got = fs.fused_sweeps_2d(planes, dk, bb, x, **kw)
        torch.cuda.synchronize()
        steps = (kw["niter"] - (x is None) + kw["want_resid"])
        if kw["niter"] == 0:
            want = {step: 1, sweeps: 0}
        else:
            want = {step: 0, sweeps: max(1, -(-steps // fs.SWEEP_BUDGET_2D))}
        assert {k: _cuda.launches[k] - n0[k] for k in want} == want, kw
        ref = (fs.fused_sweeps_2d_plain(planes, dk, bb, x, **kw)
               if held == "plain" else
               _k2_step_chain(planes, dk, bb, x, kw))
        chain = (_k2_step_chain(planes, dk, bb, x, kw)
                 if sym and kw["niter"] > 0 else None)
        again = fs.fused_sweeps_2d(planes, dk, bb, x, **kw)
        framed = fs.fused_sweeps_2d(_nan_framed(planes), dk, bb, x, **kw)
        got, ref, again, framed, chain = (
            v if isinstance(v, tuple) or v is None else (v,)
            for v in (got, ref, again, framed, chain))
        for i, (g, r, h, w) in enumerate(zip(got, ref, again, framed)):
            assert torch.equal(g, h), kw
            assert torch.equal(g, w), (kw, i, planes.dtype, "NaN frame")
            if chain is not None:
                assert torch.equal(g, chain[i]), (kw, i, planes.dtype)
            if held == "steps":
                assert torch.equal(g, r), (kw, i, planes.dtype)
                continue
            scale = float(r.abs().max())
            if kw["want_resid"] and i == len(got) - 1 and bb is not None:
                scale = max(scale, float(bb.abs().max()))
            err = float((g - r).abs().max())
            assert err <= TOL * scale, (kw, i, planes.dtype, err, scale)


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", _K2_GRIDS)
def test_k2_matches_plain_on_card(dev, nd, shape):
    """K2 on full storage (:func:`_k2_case`)."""
    _k2_case(dev, shape, nd, sym=False)


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
    # the bf16-operand passes run the tensor-core body, the f32 ones the
    # CUDA-core body
    entry = "pyfem_otf_3d_tc" if bf16 else "pyfem_otf_3d"
    n0 = _cuda.launches[entry]
    got = otf3d.otf_apply_3d(lv.rho, lv.maskf, lv.w3, lv.wd, bb, xx, **kw)
    torch.cuda.synchronize()
    passes = kw["niter"] + (1 if kw.get("want_resid", True) else 0)
    assert _cuda.launches[entry] == n0 + passes
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


# -- K5 and K6's tensor cores on a ragged grid -----------------------------


def _ragged_level(dev, physics, elem_path="uniform"):
    from pyfem_gpu_testflight_tpu_torch import multigrid

    nx, ny, nz = 9, 7, 5
    a = multigrid.GMGAssembler3D(nx, ny, nz, 2.0, 1.5, 1.0, physics, p=3.0,
                                 device=dev, elem_path=elem_path)
    rng = np.random.default_rng(5)
    rho = torch.as_tensor(rng.uniform(0.3, 1.0, (nz, ny, nx)),
                          dtype=torch.float32, device=dev)
    f = lambda: torch.as_tensor(rng.standard_normal((a.nd, nz, ny, nx)),
                                dtype=torch.float32, device=dev)
    return a, rho, f


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_k5_ragged_matches_plain_on_card(dev, physics, prec):
    """Every smoothing call of nu = 1..4 is one call of K5, within 1e-5
    of max|plain| (the residual of max|b|)."""
    import itertools

    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    a, rho, f = _ragged_level(dev, physics)
    st = a.static_levels[0]
    ck, dk, lk = fa.assemble_pack_3d(rho, st.maskf, st.W, a.N, nd=a.nd,
                                     p=3.0, lp_dtype=torch.bfloat16)
    c = ck if prec == "f32" else lk
    b, x0 = torch.where(st.mask, 0.0, f()), torch.where(st.mask, 0.0, f())
    calls = 0
    for niter, x0_zero, resid in itertools.product((1, 2, 3, 4),
                                                   (True, False),
                                                   (True, False)):
        kw = dict(niter=niter, want_resid=resid,
                  omega=multigrid.smoothing_omegas(niter, 3.0))
        x = None if x0_zero else x0
        n0 = _cuda.launches["pyfem_sweeps_3d"]
        got = fs.fused_sweeps3d(c, dk, b, x, **kw)
        ref = fs.fused_sweeps3d_plain(c, dk, b, x, **kw)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_sweeps_3d"] == n0 + 1
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert _rel(got[0], ref[0]) <= TOL
        if resid:
            err = float((got[1] - ref[1]).abs().max())
            assert err <= TOL * float(b.abs().max())
        calls += 1
    assert calls == 16


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_k6_tensor_core_pass_matches_plain_on_card(dev, physics):
    """Each bf16-operand pass (first sweep, sweep, residual, matvec) is
    one launch of the tensor-core body, within 1e-5 of max|plain| (a
    residual of max(|r|, |b|))."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    a, rho, f = _ragged_level(dev, physics, "otf")
    _, lv = a.assemble(rho.reshape(-1))
    b, x0 = torch.where(lv.mask, 0.0, f()), torch.where(lv.mask, 0.0, f())
    args = (lv.rho, lv.maskf, lv.w3, lv.wd)
    for bb, xx, kw in ((b, None, dict(niter=1, want_resid=False)),
                       (b, x0, dict(niter=1, want_resid=False)),
                       (b, x0, dict(niter=0)),
                       (b, x0, dict(niter=0, neg_resid=True)),
                       (None, x0, dict(niter=0, neg_resid=True))):
        kw.update(p=lv.p, omega=0.55, mxu_bf16=True)
        n0 = _cuda.launches["pyfem_otf_3d_tc"]
        got = otf3d.otf_apply_3d(*args, bb, xx, **kw)
        ref = otf3d.otf_apply_3d_plain(*args, bb, xx, **kw)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_otf_3d_tc"] == n0 + 1
        scale = float(ref.abs().max())
        if kw["niter"] == 0 and bb is not None:
            scale = max(scale, float(bb.abs().max()))
        assert float((got - ref).abs().max()) <= TOL * scale


# -- K3 on every level of bench 3D and on ragged grids ---------------------

# bench 3D's levels 65^3..3^3; 9x7x5 and 13x11x7 (a block's 128 slots end
# inside a row, odd rows so float2 / bf16x2 stores alternate with
# scalars); 600x3x2 (rows of 300 slots cut into blocks of their own, so
# the shared boxes stay 256 nodes wide: K3 has no width limit)
_K3_GRIDS = [(n, n, n) for n in (65, 33, 17, 9, 5, 3)] + [
    (9, 7, 5), (13, 11, 7), (600, 3, 2)]


@pytest.mark.parametrize("shape", _K3_GRIDS)
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("sym", [True, False])
def test_k3_every_level_and_ragged_grid_on_card(dev, shape, physics, sym):
    """K3 in either storage, nd 3 and 1: one launch, planes and free
    inverse diagonal within 1e-5 of max|plain|, 0 at fixed dofs, the bf16
    copy its f32 planes rounded, a repeat call bit-identical."""
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    nx, ny, nz = shape
    a = multigrid.GMGAssembler3D(nx, ny, nz, 2.0, 1.5, 1.0, physics, p=3.0,
                                 device=dev)
    st = a.static_levels[0]
    rho = torch.as_tensor(np.random.default_rng(9).uniform(
        0.2, 1.0, (nz, ny, nx)), dtype=torch.float32, device=dev)
    args = (rho, st.maskf, st.W, a.N)
    kw = dict(nd=a.nd, p=3.0, lp_dtype=torch.bfloat16, sym=sym)
    n0 = _cuda.launches["pyfem_assemble_3d"]
    ck, dk, lk = fa.assemble_pack_3d(*args, **kw)
    cp, dp, _ = fa.assemble_pack_3d_plain(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_assemble_3d"] == n0 + 1
    free = st.maskf > 0
    assert ck.shape == cp.shape
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert bool((dk[~free] == 0).all())
    assert torch.equal(lk, ck.to(torch.bfloat16))
    again = fa.assemble_pack_3d(*args, **kw)
    assert all(torch.equal(x, y) for x, y in zip(again, (ck, dk, lk)))


# -- the 3D stencil pass (K4, K5's passes) and K6's f32 body, ragged ------

# grids that cut a block's chunk of 128 nodes of a plane at every kind of
# edge: 3^3 (one chunk a plane), 9x7x5 and 13x11x7 (a chunk ends inside
# a row), 67x65x37 (rows of 67 across chunks); 33^3 is the level whose
# f32 half-storage pass takes the 168-register instance on an H100
_PASS_GRIDS = [(3, 3, 3), (9, 7, 5), (13, 11, 7), (33, 33, 33),
               (67, 65, 37)]


@pytest.mark.parametrize("shape", _PASS_GRIDS)
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("sym", [True, False])
def test_stencil_pass_3d_matches_plain_on_card(dev, shape, physics, sym):
    """Every mode of one stencil pass (sweep, residual, negated residual,
    matvec both signs, the elementwise first sweep from x = None), on f32
    and bf16 planes in either storage, is one launch within 1e-5 of
    max|plain| (a residual of max(|r|, |b|))."""
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nx, ny, nz = shape
    a = multigrid.GMGAssembler3D(nx, ny, nz, 2.0, 1.5, 1.0, physics, p=3.0,
                                 device=dev)
    st = a.static_levels[0]
    rng = np.random.default_rng(7)
    rho = torch.as_tensor(rng.uniform(0.3, 1.0, (nz, ny, nx)),
                          dtype=torch.float32, device=dev)
    f = lambda: torch.as_tensor(rng.standard_normal((a.nd, nz, ny, nx)),
                                dtype=torch.float32, device=dev)
    ck, dk, lk = fa.assemble_pack_3d(rho, st.maskf, st.W, a.N, nd=a.nd,
                                     p=3.0, lp_dtype=torch.bfloat16, sym=sym)
    assert fs.is_full_storage_3d(ck, a.nd) == (not sym)
    b, x0 = torch.where(st.mask, 0.0, f()), torch.where(st.mask, 0.0, f())
    xr = f()
    for c in (ck, lk):
        for args, kw in (((c, dk, b, x0), dict(mode="sweep", omega=0.5)),
                         ((c, None, b, x0), dict(mode="resid")),
                         ((c, None, b, x0), dict(mode="resid",
                                                 neg_resid=True)),
                         ((c, None, None, xr), dict(mode="matvec",
                                                    neg_resid=True)),
                         ((c, None, None, xr), dict(mode="matvec"))):
            n0 = _cuda.launches["pyfem_sweep_3d"]
            got = fs.fused_sweep_3d(*args, **kw)
            ref = fs.fused_sweep_3d_plain(*args, **kw)
            torch.cuda.synchronize()
            assert _cuda.launches["pyfem_sweep_3d"] == n0 + 1
            scale = float(ref.abs().max())
            if kw["mode"] == "resid":
                scale = max(scale, float(b.abs().max()))
            assert float((got - ref).abs().max()) <= TOL * scale
        # x = None: the elementwise first sweep, then one stencil sweep
        kw = dict(niter=2, want_resid=True, omega=(0.6, 0.4))
        got = fs.fused_sweeps3d(c, dk, b, None, **kw)
        ref = fs.fused_sweeps3d_plain(c, dk, b, None, **kw)
        torch.cuda.synchronize()
        assert _rel(got[0], ref[0]) <= TOL
        assert float((got[1] - ref[1]).abs().max()) <= TOL * float(
            b.abs().max())


@pytest.mark.parametrize("nd", [1, 3])
def test_stencil_pass_3d_refuses_a_window_past_shared_memory(dev, nd):
    """A grid one node wider than the x window a block can stage (nx =
    3160 at nd = 3, 9616 at nd = 1) is refused with the limit named, by
    both entry points, before any launch."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nx = 3160 if nd == 3 else 9616
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    c, x = z(nd * nd * 27, 1, 1, nx), z(nd, 1, 1, nx)
    n0 = (_cuda.launches["pyfem_sweep_3d"], _cuda.launches["pyfem_sweeps_3d"])
    with pytest.raises(ValueError, match="too wide"):
        fs.fused_sweep_3d(c, x=x, mode="matvec")
    with pytest.raises(ValueError, match="too wide"):
        fs.fused_sweeps3d(c, x, x, None, niter=1)
    assert (_cuda.launches["pyfem_sweep_3d"],
            _cuda.launches["pyfem_sweeps_3d"]) == n0


@pytest.mark.parametrize("shape", [(9, 7, 5), (13, 11, 7), (17, 9, 11)])
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_k6_f32_body_matches_plain_on_card(dev, shape, physics):
    """Each float32 pass of K6 (first sweep, sweep, residual both signs,
    matvec) is one launch of the f32 body, within 1e-5 of max|plain| (a
    residual of max(|r|, |b|)); 17x9x11 cuts every edge of its 16 x 4 x 2
    node tile and of a quad's 4 nodes."""
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    nx, ny, nz = shape
    a = multigrid.GMGAssembler3D(nx, ny, nz, 2.0, 1.5, 1.0, physics, p=3.0,
                                 device=dev, elem_path="otf")
    rng = np.random.default_rng(9)
    rho = torch.as_tensor(rng.uniform(0.3, 1.0, (nz, ny, nx)),
                          dtype=torch.float32, device=dev)
    f = lambda: torch.as_tensor(rng.standard_normal((a.nd, nz, ny, nx)),
                                dtype=torch.float32, device=dev)
    _, lv = a.assemble(rho.reshape(-1))
    b, x0 = torch.where(lv.mask, 0.0, f()), torch.where(lv.mask, 0.0, f())
    args = (lv.rho, lv.maskf, lv.w3, lv.wd)
    for bb, xx, kw in ((b, None, dict(niter=1, want_resid=False)),
                       (b, x0, dict(niter=1, want_resid=False)),
                       (b, x0, dict(niter=0)),
                       (b, x0, dict(niter=0, neg_resid=True)),
                       (None, x0, dict(niter=0, neg_resid=True))):
        kw.update(p=lv.p, omega=0.55, mxu_bf16=False)
        n0 = _cuda.launches["pyfem_otf_3d"]
        got = otf3d.otf_apply_3d(*args, bb, xx, **kw)
        ref = otf3d.otf_apply_3d_plain(*args, bb, xx, **kw)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_otf_3d"] == n0 + 1
        scale = float(ref.abs().max())
        if kw["niter"] == 0 and bb is not None:
            scale = max(scale, float(bb.abs().max()))
        assert float((got - ref).abs().max()) <= TOL * scale


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


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("case", ["hex8", "tet10", "brick20"])
def test_k8_ragged_group_and_layout_on_card(dev, case, physics):
    """K8 on one element less than the mesh (a ragged last element group
    for every group size but brick20's 1) and on one element:
    within 1e-5 of max|plain|, KeT the transposed view of a contiguous
    (nelems, ndpe, ndpe) buffer, a repeat call bit-identical."""
    from pyfem_gpu_testflight_tpu_torch.elements import get_element
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3
    from pyfem_gpu_testflight_tpu_torch.ops import stiffness

    etype, kw = _STIFF_CASES[case]
    conn, X, _f, _l = _jittered(kw, seed=11)
    et = get_element(etype)
    mu, lam = stiffness.lame_params(10.0, 0.3, et.ndims)
    ndpe = et.nnodes * (3 if physics == "elasticity" else 1)
    for E in (len(conn) - 1, 1):
        Xe = torch.as_tensor(X[conn[:E]], dtype=torch.float32, device=dev)
        XeT = ek.transpose_xe(Xe)
        cq = torch.as_tensor(np.random.default_rng(E).uniform(
            0.3, 1.0, (et.nquads, E)), dtype=torch.float32, device=dev)
        if physics == "elasticity":
            run = lambda f: f(XeT, cq, mu, lam, etype=etype)
            fns = (ek3.elasticity_stiffness_3d,
                   ek3.elasticity_stiffness_3d_plain)
        else:
            run = lambda f: f(XeT, cq, etype=etype)
            fns = (ek3.poisson_stiffness_3d, ek3.poisson_stiffness_3d_plain)
        got, ref = run(fns[0]), run(fns[1])
        torch.cuda.synchronize()
        assert got.shape == ref.shape == (ndpe * ndpe, E)
        assert got.t().is_contiguous()
        assert _rel(got, ref) <= TOL
        assert torch.equal(got, run(fns[0]))


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_element_jacobian_makes_no_layout_copy_on_card(dev, monkeypatch,
                                                       physics):
    """``element_jacobian(kernel="cuda")`` on hex8 returns K8's own
    buffer as (nelems, ndpe, ndpe): the same address K8 wrote, no copy."""
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3

    conn, X, fixed, force = _jittered(_STIFF_CASES["hex8"][1], seed=12)
    name = f"{physics}_stiffness_3d"
    seen = []
    real = getattr(ek3, name)

    def spy(*a, **kw):
        KeT = real(*a, **kw)
        seen.append(KeT.data_ptr())
        return KeT

    monkeypatch.setattr(ek3, name, spy)
    if physics == "elasticity":
        m = pt.LinearElasticity("hex8", X, conn, fixed, None, force,
                                dtype=torch.float32, device=dev,
                                kernel="cuda")
    else:
        m = pt.LinearPoisson("hex8", X, conn, fixed[::3] // 3,
                             dtype=torch.float32, device=dev, kernel="cuda")
    Ke = m.element_jacobian(0.6)
    ndpe = 8 * m.ndof_per_node
    assert Ke.shape == (m.nelems, ndpe, ndpe) and Ke.is_contiguous()
    assert seen == [Ke.data_ptr()]


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
@pytest.mark.parametrize("shape", [(ny, nx) for nx, ny in _K2_GRIDS])
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
    assert torch.equal(got, sm.stencil_matvec_2d(c, u))


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", _K1_GRIDS)
def test_k1_sym_matches_plain_on_card(dev, nd, shape):
    _k1_case(dev, shape, nd, sym=True)


@pytest.mark.parametrize("nd", [1, 2])
@pytest.mark.parametrize("shape", _K2_GRIDS)
def test_k2_sym_matches_plain_on_card(dev, nd, shape):
    """K2-sym, on the kept planes of half storage (:func:`_k2_case`): one
    launch of ``pyfem_sweeps_2d_sym`` a call, each equal to the step
    kernel's chain bit for bit."""
    _k2_case(dev, shape, nd, sym=True)


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


def _newton_model(dev, n):
    """A float32 NonlinearPoisson on the n x n creator raster, attached,
    and a Newton-like iterate u (0 at the fixed dofs)."""
    import pyfem_gpu_testflight_tpu_torch as pt

    conn, X, fixed = pt.ProblemCreator(n, n).create_poisson_problem()
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, dtype=torch.float32,
                            device=dev).attach_structured_grid(n, n)
    x = m.X[:, 0]
    u = torch.where(m.bc.mask, 0.0, -4.0 * torch.sin(2.5 * x) * (
        1.0 + 0.1 * torch.cos(7.0 * m.X[:, 1])))
    return m, m._xdv(np.ones(10) / 10), u


@pytest.mark.parametrize("n", [1025, 65, 18])
def test_k1_on_newton_coefficient_field_on_card(dev, n):
    """K1 nd=1 at p=0 on c = h(x)(1 + u^2) >= 1 (so far K1 was held on
    densities <= 1), on every level of the Newton hierarchy."""
    from pyfem_gpu_testflight_tpu_torch.models.nonlinear_poisson import (
        hfunc,
    )
    from pyfem_gpu_testflight_tpu_torch.multigrid import _restrict_nodal
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    m, xdv, u = _newton_model(dev, n)
    asm = m._gmg_newton
    rho = (hfunc(xdv, m.X) * (1.0 + u * u)).reshape(n, n).contiguous()
    assert float(rho.min()) >= 1.0 and float(rho.max()) > 4.0
    for st in asm.static_levels:
        args = (rho, st.maskf, st.W, asm.N)
        n0 = _cuda.launches["pyfem_assemble_2d"]
        ck, dk = fa.assemble_pack_2d(*args, nd=1, p=0.0)
        cp, dp = fa.assemble_pack_2d_plain(*args, nd=1, p=0.0)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_assemble_2d"] == n0 + 1
        free = st.maskf > 0
        assert _rel(ck, cp) <= TOL
        assert _rel(dk[free], dp[free]) <= TOL
        assert bool((dk[~free] == 0).all())
        rho = _restrict_nodal(rho)


@pytest.mark.parametrize("n", [1025, 65, 18])
def test_k9_on_nonsymmetric_tangent_planes_on_card(dev, n):
    """K9 nd=1 float32 on the eliminated (nonsymmetric) Newton tangent
    planes, and float64 on the upcast SPD planes (the residual flux)."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    m, xdv, u = _newton_model(dev, n)
    st = m._gmg_newton.static_levels[0]
    cs, cr = m._uniform_tangent_coeffs(xdv, u.reshape(n, n))
    ce = st.op.bc_eliminate(cs + cr, st.mask)
    assert float((ce[0, 0, 1, 2, :, :-1] - ce[0, 0, 1, 0, :, 1:]).abs()
                 .max()) > 0  # nonsymmetric
    v = torch.as_tensor(np.random.default_rng(9).standard_normal((1, n, n)),
                        dtype=torch.float32, device=dev)
    for c, x in ((ce, v), (cs.double(), u.double().reshape(1, n, n))):
        n0 = _cuda.launches["pyfem_stencil_2d"]
        got = sm.stencil_matvec_2d(c, x)
        ref = sm.stencil_matvec_2d_plain(c, x)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_stencil_2d"] == n0 + 1
        assert got.dtype == x.dtype and _rel(got, ref) <= TOL


def test_newton_gmg_runs_on_card(dev):
    """The fused gmg Newton at bench newton's contract on a 65^2 raster:
    converged in <= 12 iterations at a float64 true residual ratio <=
    2e-2, K1 once per level per tangent solve, K2 and both K9 forms
    launched."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    n = 65
    m, xdv, _u = _newton_model(dev, n)
    nlev = len(m._gmg_newton.static_levels)
    _cuda.reset_launches()
    u, k, rn = m.solve_nonlinear_fused(
        method="gmg", xdv=xdv, tol=2e-2, atol=0.0, lin_rtol=1e-2,
        lin_maxiter=40, max_iter=12, verbose=False)
    torch.cuda.synchronize()
    rns = m.last_solve_stats["resnorms"]
    assert k <= 12 and rns[-1] <= 2e-2 * rns[0]
    assert bool(torch.isfinite(u).all()) and rn.dtype == torch.float64
    assert _cuda.launches["pyfem_assemble_2d"] == nlev * (k - 1)
    assert _cuda.launches["pyfem_sweeps_2d"] > 0  # K2's smoothing calls
    assert _cuda.launches["pyfem_stencil_2d"] > k


# -- p-multigrid (tet10 / brick20 lattices) and the Chebyshev smoother ------


def _pmg_model(dev, et, n, dtype=torch.float32):
    import pyfem_gpu_testflight_tpu_torch as pt

    conn, X, fixed, force = pt.ProblemCreator(
        n, n, n, element_type=et).create_linear_elasticity_problem()
    m = pt.LinearElasticity("tet10" if et == "tet" else "brick20", X, conn,
                            fixed, None, force, dtype=dtype, device=dev)
    return m.attach_pmg(n, n, n)


@pytest.mark.parametrize("et", ["tet", "brick20"])
def test_pmg_runs_on_card(dev, et):
    """pmg at 17^3 in float32 on the card: K3 once per corner level and
    K5 launched (the corner V-cycle's Jacobi smoothing; K4 runs only
    under ``gmg_options=dict(smoother="chebyshev")``), the solution
    within 1e-3 (rel L2) of the float64 plain-version solve on the CPU,
    iterations within 1 of it."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    n = 17
    m = _pmg_model(dev, et, n)
    nlev = len(m._pmg.asm.sizes)
    _cuda.reset_launches()
    u = m.solve(method="pmg", rtol=1e-6)
    torch.cuda.synchronize()
    k = m.last_solve_stats["iters"]
    assert _cuda.launches["pyfem_assemble_3d"] == nlev
    assert _cuda.launches["pyfem_sweeps_3d"] > 0
    ref = _pmg_model("cpu", et, n, torch.float64)
    u64 = ref.solve(method="pmg", rtol=1e-6)
    assert abs(k - ref.last_solve_stats["iters"]) <= 1
    err = float(torch.linalg.norm(u.double().cpu() - u64)
                / torch.linalg.norm(u64))
    assert bool(torch.isfinite(u).all()) and err <= 1e-3, err


@pytest.mark.parametrize("et", ["tet", "brick20"])
def test_pmg_lattice_matvec_is_deterministic_on_card(dev, et):
    m = _pmg_model(dev, et, 17)
    pmg = m._pmg
    assert pmg._lat_off is not None
    rho = np.random.default_rng(9).uniform(0.3, 1.0, m.nnodes)
    Ke = m.element_jacobian(rho)
    v = torch.as_tensor(np.random.default_rng(10).standard_normal(m.ndof),
                        dtype=torch.float32, device=dev)
    y1 = pmg._lattice_matvec(Ke, v)
    y2 = pmg._lattice_matvec(Ke, v)
    assert torch.equal(y1, y2)
    assert _rel(y1, m.matvec(Ke, v)) <= TOL


def _on_cpu(level):
    """A copy of a multigrid level with every tensor on the CPU."""
    import copy

    out = copy.copy(level)
    for k, v in vars(level).items():
        if torch.is_tensor(v):
            setattr(out, k, v.cpu())
    return out


@pytest.mark.parametrize("route", ["2d", "3d", "3d otf"])
def test_chebyshev_gmg_matches_plain_on_card(dev, route):
    """One ``smoother="chebyshev"`` V-cycle on the card (K2 at niter=0,
    K4, or K6 residual passes) against the same V-cycle on the same
    levels moved to the CPU (the kernels' plain versions), float32."""
    from pyfem_gpu_testflight_tpu_torch import multigrid

    if route == "2d":
        a = multigrid.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                                   device=dev, smoother="chebyshev")
        n = NX * NY
    else:
        a = multigrid.GMGAssembler3D(
            17, 17, 17, 1.0, 1.0, 1.0, "elasticity", p=3.0, device=dev,
            smoother="chebyshev",
            elem_path="otf" if route == "3d otf" else "uniform")
        n = 17 ** 3
    rho = torch.as_tensor(np.random.default_rng(11).uniform(0.3, 1.0, n),
                          dtype=torch.float32, device=dev)
    gmg, lv0 = a.assemble(rho)
    r = torch.as_tensor(np.random.default_rng(12).standard_normal(
        tuple(lv0.mask.shape)), dtype=torch.float32, device=dev)
    r = torch.where(lv0.mask, 0.0, r)
    got = gmg.apply(r)
    plain = multigrid.GMG([_on_cpu(lv) for lv in gmg.levels],
                          smoother="chebyshev", cheb_lam=gmg.cheb_lam)
    torch.cuda.synchronize()
    assert _rel(got.cpu(), plain.apply(r.cpu())) <= TOL


# 3D topology optimization and complex-step inputs -----------------------


def _topo3d_pair(pt, dev, n, dtype=torch.float32):
    """bench topo --topo-3d's settings at (2n-1) x n x n: a model on its
    GMG grid and a structured Helmholtz filter on ``dev``."""
    nx = 2 * n - 1
    c = pt.ProblemCreator(nnodes_x=nx, nnodes_y=n, nnodes_z=n,
                          element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                            dtype=dtype, device=dev)
    m.attach_structured_grid(nx, n, n, omega="cheby",
                             smoother_dtype=torch.bfloat16)
    f = pt.Helmholtz(0.01, "hex8", X, conn, dtype=dtype, rtol=1e-6,
                     device=dev)
    f.attach_structured_grid(nx, n, n)
    return m, f


@pytest.mark.parametrize("n", [9, 33])
def test_k4_filter_matvec_matches_plain_on_card(dev, n):
    """K4 at nd=1 on a 3D filter's 27 full-storage planes (K and R), the
    product the float32 3D Helmholtz filter runs."""
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    _m, f = _topo3d_pair(pt, dev, n)
    shape = (n, n, 2 * n - 1)
    assert tuple(f._coeffK.shape) == (27,) + shape
    x = torch.as_tensor(np.random.default_rng(13).uniform(
        0.0, 1.0, (1,) + shape), dtype=torch.float32, device=dev)
    for c in (f._coeffK, f._coeffR):
        n0 = _cuda.launches["pyfem_sweep_3d"]
        got = fs.fused_sweep_3d(c, x=x, mode="matvec", neg_resid=True)
        ref = fs.fused_sweep_3d_plain(c, x=x, mode="matvec", neg_resid=True)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_sweep_3d"] == n0 + 1
        assert _rel(got, ref) <= TOL


# 3D DeviceTopo on the card against the CPU's plain versions: the largest
# relative difference of the design x and of the objectives after 3
# iterations at 17x9x9.  Read on an H100 (700 W): x 3.9e-5, objectives
# 1.1e-4 (float32 state solves at rtol 1e-6 on bf16 smoother copies,
# summed in another order); the limit is 9x the larger reading.
TOPO3D_CARD_TOL = 1e-3


def test_device_topo_3d_on_card_matches_cpu(dev):
    """Three 3D DeviceTopo iterations at 17x9x9 (bench topo --topo-3d's
    settings, float32) on the card (K3, K4, K5) against the same run on
    the CPU (their plain versions)."""
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    runs = {}
    for where in (dev, torch.device("cpu")):
        m, f = _topo3d_pair(pt, where, 9)
        _cuda.reset_launches()
        d = pt.opt.DeviceTopo(m, f, fixed_volume=0.4)
        x, _rho = d.optimize(max_iterations=3, verbose=False, log_every=1)
        runs[where.type] = (x.cpu(), [h["obj"] for h in d.history],
                            dict(_cuda.launches))
    (xc, oc, lc), (xp, op, lp) = runs["cuda"], runs["cpu"]
    nlev = len(m._gmg_asm.sizes)
    assert lc["pyfem_assemble_3d"] == 3 * nlev
    assert lc["pyfem_sweep_3d"] > 0 and lc["pyfem_sweeps_3d"] > 0
    assert lp["pyfem_sweep_3d"] == 0  # the CPU run: plain versions only
    dx = float((xc - xp).abs().max() / xp.abs().max())
    do = max(abs(a - b) / abs(b) for a, b in zip(oc, op))
    print(f"3D DeviceTopo card vs CPU: x {dx:.3e}, objectives {do:.3e}")
    assert all(np.isfinite(oc))
    assert dx <= TOPO3D_CARD_TOL and do <= TOPO3D_CARD_TOL


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_complex_step_element_jacobian_on_card(dev, physics):
    """A complex density keeps its imaginary part on the card: complex
    element matrices and the assembled CSR (complex segment sums) equal
    the CPU's; a ``kernel="cuda"`` model takes the einsum route for it."""
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    c = pt.ProblemCreator(5, 4, 3, element_type="block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    rng = np.random.default_rng(14)
    rho = rng.uniform(0.3, 1.0, X.shape[0]) + 1e-30j * rng.uniform(
        0.0, 1.0, X.shape[0])

    def make(where, **kw):
        if physics == "elasticity":
            return pt.LinearElasticity("hex8", X, conn, fixed, None, force,
                                       p=3.0, device=where, **kw)
        return pt.LinearPoisson("hex8", X, conn, np.unique(fixed // 3),
                                p=3.0, device=where, **kw)

    mc, mp = make(dev), make("cpu")
    Ke, Ke_ref = mc.element_jacobian(rho), mp.element_jacobian(rho)
    assert Ke.dtype == torch.complex128 and Ke.is_cuda
    assert _rel(Ke.real.cpu(), Ke_ref.real) <= 1e-12
    assert _rel(Ke.imag.cpu(), Ke_ref.imag) <= 1e-12
    K, K_ref = mc.compute_jacobian(rho), mp.compute_jacobian(rho)
    assert abs(K - K_ref).max() <= 1e-12 * abs(K_ref).max()
    mk = make(dev, dtype=torch.float32, kernel="cuda")
    n0 = _cuda.launches["pyfem_stiffness_3d"]
    Kek = mk.element_jacobian(rho)
    torch.cuda.synchronize()
    assert Kek.dtype == torch.complex64
    assert _cuda.launches["pyfem_stiffness_3d"] == n0


def _ragged_csr(n, mean, seed):
    """A random n x n CSR matrix with ragged rows about ``mean`` long:
    empty rows, single-entry rows and rows several times the mean."""
    from scipy import sparse

    rng = np.random.default_rng(seed)
    lens = rng.poisson(mean, n)
    lens[::17] = 0
    lens[5::23] = 1
    lens[7::29] = 4 * mean + 3
    lens = np.minimum(lens, n)
    indptr = np.concatenate([[0], np.cumsum(lens)])
    indices = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                              for k in lens])
    vals = rng.standard_normal(indices.size)
    return sparse.csr_matrix((vals, indices, indptr), shape=(n, n))


@pytest.mark.parametrize("mean", [1, 14, 25, 40, 82, 300])
def test_u1_csr_spmv_matches_plain_on_card(dev, mean):
    """U1 on ragged rows at every lanes-per-row group (1, 2, 4, 8, 16 and
    32 for these mean lengths), float32
    and float64: one launch, within TOL (f64: 1e-12) of the plain
    version, a repeat call bit-identical."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda, spmv

    A = _ragged_csr(5003, mean, mean)
    assert spmv.csr_group(A.shape[0], A.nnz) == {
        1: 1, 14: 2, 25: 4, 40: 8, 82: 16, 300: 32}[mean]
    ip = torch.as_tensor(A.indptr, dtype=torch.int32, device=dev)
    ix = torch.as_tensor(A.indices, dtype=torch.int32, device=dev)
    for dt, tol in ((torch.float32, TOL), (torch.float64, 1e-12)):
        v = torch.as_tensor(A.data, dtype=dt, device=dev)
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(
            A.shape[0]), dtype=dt, device=dev)
        n0 = _cuda.launches["pyfem_csr_spmv"]
        y = spmv.csr_matvec(ip, ix, v, x)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_csr_spmv"] == n0 + 1
        ref = spmv.csr_matvec_plain(ip, ix, v, x)
        assert y.dtype == dt and _rel(y, ref) <= tol
        assert torch.equal(y, spmv.csr_matvec(ip, ix, v, x))
        y_host = A.astype(np.float64) @ x.double().cpu().numpy()
        assert np.abs(y.double().cpu().numpy() - y_host).max() <= \
            tol * 10 * np.abs(y_host).max()


@pytest.mark.parametrize("masked", [False, True])
def test_u2_dia_spmv_matches_plain_on_card(dev, masked):
    """U2 with offsets past both ends of the vector and more offsets
    than one shared-memory chunk (1,500 > 1,024), float32 and float64,
    plain and Dirichlet-masked: one launch, within TOL (f64: 1e-12) of
    the plain version."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda, spmv

    n = 3001
    rng = np.random.default_rng(2)
    offs = np.unique(np.concatenate([
        [-n - 5, -n + 1, 0, n - 1, n + 7],
        rng.integers(-n + 1, n, 1495)]))
    offsets = torch.as_tensor(offs.astype(np.int32), device=dev)
    mask = (torch.as_tensor(rng.uniform(size=n) < 0.2, device=dev)
            if masked else None)
    for dt, tol in ((torch.float32, TOL), (torch.float64, 1e-12)):
        dia = torch.as_tensor(rng.standard_normal((offs.size, n)),
                              dtype=dt, device=dev)
        u = torch.as_tensor(rng.standard_normal(n), dtype=dt, device=dev)
        n0 = _cuda.launches["pyfem_dia_spmv"]
        y = spmv.dia_matvec(offsets, dia, u, mask)
        torch.cuda.synchronize()
        assert _cuda.launches["pyfem_dia_spmv"] == n0 + 1
        ref = spmv.dia_matvec_plain(offsets, dia, u, mask)
        assert y.dtype == dt and _rel(y, ref) <= tol
        if masked:
            assert torch.equal(y[mask], u[mask])


def test_amg_pcg_on_card_matches_cpu(dev, tmp_path):
    """AMG-PCG (float64) on the 12x80 torque arm: the card's run takes
    U1 for every level product (no plain version), the CPU's iterations,
    and its solution within 1e-10 of the CPU's."""
    from pyfem_gpu_testflight_tpu_torch import unstructured
    from pyfem_gpu_testflight_tpu_torch.examples.torque_arm import (
        arm_model, synthesize_arm_inp,
    )
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    inp = synthesize_arm_inp(str(tmp_path / "arm.inp"), nr=12, nt=80)
    model, X = arm_model(inp, device="cpu")[:2]
    K, b = model.bc.apply_scipy(model.assemble_scipy(
        model.element_jacobian()), model.compute_rhs().numpy())
    xc, kc, _ = unstructured.amg_pcg(K, b, nd=2, coords=X, rtol=1e-10,
                                     device="cpu")
    n0 = _cuda.launches["pyfem_csr_spmv"]
    cache = {}
    xg, kg, rng_ = unstructured.amg_pcg(K, b, nd=2, coords=X, rtol=1e-10,
                                        device=dev, cache=cache)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_csr_spmv"] > n0
    assert int(kg) == int(kc)
    assert float((xg.cpu() - xc).abs().max() / xc.abs().max()) <= 1e-10
    # a value-only rebuild on the card keeps the device patterns
    pats = [sl["csr"][0] for sl in cache["structure"]["levels"]]
    p0 = cache["pattern0"][0]
    xg2, kg2, _ = unstructured.amg_pcg(K, b, nd=2, coords=X, rtol=1e-10,
                                       device=dev, cache=cache)
    assert all(a is c for a, c in zip(
        pats, [sl["csr"][0] for sl in cache["structure"]["levels"]]))
    assert cache["pattern0"][0] is p0 and int(kg2) == int(kg)


def test_postprocess_float32_matches_float64_on_card(dev):
    """Phase 12a at 65x33: ``Assembler.solve(method="gmg")`` (K1 and K2
    launched) in float32, then the float32 strains, stresses and nodal
    strains against the same functions in float64 on the same u; the
    nodal strains bit-identical across two runs; the lumped mass sums to
    density * area * nd."""
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import postprocess as post
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    c = pt.ProblemCreator(NX, NY)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m32, m64 = (pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                                    p=3.0, dtype=dt, device=dev)
                for dt in (torch.float32, torch.float64))
    rho = np.random.default_rng(0).uniform(0.3, 1.0, m32.nnodes)
    m32.attach_structured_grid(NX, NY, omega="cheby",
                               smoother_dtype=torch.bfloat16)
    n0 = dict(_cuda.launches)
    u = pt.Assembler(m32).solve(method="gmg", rtol=1e-6, rho=rho)
    torch.cuda.synchronize()
    for k in ("pyfem_assemble_2d", "pyfem_sweeps_2d"):
        assert _cuda.launches.get(k, 0) > n0.get(k, 0)
    for fn, args in ((post.quadrature_strains, ()),
                     (post.quadrature_stresses, (rho,)),
                     (post.nodal_strains, ())):
        got = fn(m32, u, *args)
        assert got.dtype == torch.float32
        assert _rel(got, fn(m64, u.double(), *args)) <= 1e-5
    assert torch.equal(post.nodal_strains(m32, u), post.nodal_strains(m32, u))
    area = float(np.ptp(X[:, 0]) * np.ptp(X[:, 1]))
    ml = post.lumped_mass(m64, density=2.0)
    assert abs(float(ml.sum()) - 2.0 * area * 2) <= 1e-12 * area
