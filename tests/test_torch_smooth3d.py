"""PyTorch port, kernels K4 and K5 (``ops/fused_smooth.py``, 3D) on CPU.

K4 replaces the Pallas ``fused_sweep_3d`` (half-storage body) and K5
``fused_sweeps3d``; on CPU tensors their wrappers run the plain PyTorch
versions, gated here in float64 to 1e-12 relative against sweeps built
from the JAX ``Stencil3D.matvec`` on full planes, on a JAX-assembled
9x7x5 level (p=3, random density):

* K4 in every mode: sweep, residual and matvec, each sign;
* K5 with nu = 1..4, from x0 = 0 or a given x, with and without the
  residual, on the full-precision planes and on their bf16 copy;
* the ``Level3D`` methods that wrap them;
* K4's full-storage body (all 243 planes, the TPU kernel's
  ``_kernel3d``) in every mode against the JAX ``fused_sweep_3d`` on the
  same full planes, its Pallas kernel in interpret mode, float32 to 2e-6
  of max (summation order); K5 on full planes equals K5 on the kept
  planes of the same operator (1e-12);
* K5's coverage: ``halo_sweeps_3d`` equals the JAX one, and the port's
  ``Level3D.can_fuse3d`` holds for every call the JAX ``Level.can_fuse3d``
  (its 3D rule) covers, and past its z budget too (the port's K5 runs
  one stencil pass per launch, so it has no budget); and
  the port counterparts of the JAX gates
  ``test_fused_multi_sweep3d_matches_per_sweep`` and
  ``test_gmg3d_pcg_fused_multi_matches_per_sweep_solve``
  (``tests/test_pallas_smooth.py``) at 9^3 in float32, with their
  tolerances (the plain versions here; the card runs the kernels in
  ``tests/test_torch_cuda.py``).

On the full-precision side the JAX reference reads the JAX package's
own eliminated planes; the bf16 variants read the full planes rebuilt
from the bf16-rounded kept planes (identical values on both sides).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops import pallas_smooth as jps

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
from pyfem_gpu_testflight_tpu_torch.ops.stencil import Stencil3D

import torch_threads  # noqa: F401  (one torch thread per worker)

NX, NY, NZ = 9, 7, 5
ND = 3


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.2, 1.0, (NZ, NY, NX))
    ja = jmg.GMGAssembler3D(NX, NY, NZ, 2.0, 1.5, 1.0, "elasticity", p=3.0,
                            dtype=jnp.float64)
    op, _xe, _conn, mask, _shape, Kq, _pal, _otf = ja.static_levels[0]
    with jax.disable_jit():
        ce = op.bc_eliminate(
            op.assemble_uniform(ja.material_planes(jnp.asarray(rho)), Kq),
            mask,
        )
        d = op.diagonal(ce)
        invd = 1.0 / jnp.where(d == 0, 1.0, d)
    mask = np.asarray(mask)
    keep = [k for (k, *_r) in fs.sym_planes_3d(ND)]
    kept = torch.as_tensor(np.array(ce).reshape(-1, NZ, NY, NX)[keep])
    kept_lp = kept.to(torch.bfloat16)
    full_lp = fs.full_planes_3d(kept_lp.double(), ND).numpy()
    shape = (ND, NZ, NY, NX)
    return dict(
        ce=np.array(ce), ce_lp=full_lp, kept=kept, kept_lp=kept_lp,
        invd=np.where(mask, 0.0, np.array(invd)), mask=mask,
        mv=jax.jit(op.matvec),
        b=np.where(mask, 0.0, rng.standard_normal(shape)),
        x0=np.where(mask, 0.0, rng.standard_normal(shape)),
        xr=rng.standard_normal(shape),
    )


def _mv(lv, c, u):
    return np.asarray(lv["mv"](jnp.asarray(c), jnp.asarray(u)))


def _close(got, ref):
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


def _t(a):
    return None if a is None else torch.as_tensor(a)


@pytest.mark.parametrize("lp", [False, True])
@pytest.mark.parametrize("mode,neg", [("sweep", False), ("resid", False),
                                      ("resid", True), ("matvec", False),
                                      ("matvec", True)])
def test_plain_k4_matches_jax(level, mode, neg, lp):
    c = level["kept_lp"] if lp else level["kept"]
    ce = level["ce_lp"] if lp else level["ce"]
    x = level["xr"] if mode == "matvec" else level["x0"]
    ax = _mv(level, ce, x)
    b = level["b"]
    ref = {
        "sweep": lambda: x + 0.55 * level["invd"] * (b - ax),
        "resid": lambda: (ax - b) if neg else (b - ax),
        "matvec": lambda: ax if neg else -ax,
    }[mode]()
    out = fs.fused_sweep_3d(
        c, _t(level["invd"]) if mode == "sweep" else None,
        None if mode == "matvec" else _t(b), _t(x), mode=mode,
        neg_resid=neg, omega=0.55,
    )
    _close(out, ref)


def _sweeps_ref(lv, ce, b, x, oms, want_resid, neg):
    for om in oms:
        ax = 0.0 if x is None else _mv(lv, ce, x)
        x = (0.0 if x is None else x) + om * lv["invd"] * (b - ax)
    if not want_resid:
        return x, None
    r = b - _mv(lv, ce, x)
    return x, (-r if neg else r)


@pytest.mark.parametrize("niter", [1, 2, 3, 4])
@pytest.mark.parametrize("x0_zero", [True, False])
@pytest.mark.parametrize("lp,want_resid,neg", [
    (True, True, False),    # presmooth + residual on the bf16 copy
    (True, False, False),   # postsmooth on the bf16 copy
    (False, True, True),    # full precision, negated residual
])
def test_plain_k5_matches_jax(level, niter, x0_zero, lp, want_resid, neg):
    c = level["kept_lp"] if lp else level["kept"]
    ce = level["ce_lp"] if lp else level["ce"]
    x = None if x0_zero else level["x0"]
    oms = tmg.smoothing_omegas(niter, 3.0)
    x_ref, r_ref = _sweeps_ref(level, ce, level["b"], x, oms, want_resid, neg)
    out = fs.fused_sweeps3d(c, _t(level["invd"]), _t(level["b"]), _t(x),
                            niter=niter, want_resid=want_resid,
                            neg_resid=neg, omega=oms)
    if want_resid:
        _close(out[0], x_ref)
        _close(out[1], r_ref)
    else:
        _close(out, x_ref)


def test_level3d_methods_match_k4_k5(level):
    op = Stencil3D(NX, NY, NZ, ND)
    t = lambda k: torch.as_tensor(level[k])
    lv = tmg.Level3D(op, level["kept"], t("invd"), t("mask"), (NZ, NY, NX),
                     ND, coeff_lp=level["kept_lp"])
    b, x0 = t("b"), t("x0")
    oms = tmg.smoothing_omegas(2, 3.0)
    _close(lv.matvec(t("xr")), _mv(level, level["ce"], level["xr"]))
    assert lv.can_fuse3d(1, True, True) and not lv.can_fuse3d(0, True, True)
    # K5 = the elementwise first sweep + K4 sweeps + the K4 residual
    x, r = lv.presmooth_resid3d(b, 2, oms)
    xs = lv.sweep3d(b, oms[0] * lv.inv_diag * b, oms[1])
    _close(x, xs.numpy())
    _close(r, lv.resid3d(b, xs).numpy())
    _close(lv.postsmooth3d(b, x0, 2, oms[::-1]),
           lv.sweep3d(b, lv.sweep3d(b, x0, oms[1]), oms[0]).numpy())


def _full(level, dtype=np.float64):
    return np.ascontiguousarray(level["ce"].reshape(-1, NZ, NY, NX),
                                dtype=dtype)


@pytest.mark.parametrize("mode,neg", [("sweep", False), ("resid", False),
                                      ("resid", True), ("matvec", False),
                                      ("matvec", True)])
def test_plain_k4_full_storage_matches_jax_kernel(level, mode, neg):
    from pyfem_gpu_testflight_tpu.ops import pallas_smooth as jps

    f32 = lambda k: np.asarray(level[k], np.float32)
    c = _full(level, np.float32)
    x = f32("xr") if mode == "matvec" else f32("x0")
    d = f32("invd") if mode == "sweep" else None
    b = None if mode == "matvec" else f32("b")
    pk = lambda a: None if a is None else jps.pack_field3d(jnp.asarray(a))
    ref = np.asarray(jps.unpack_field3d(jps.fused_sweep_3d(
        jps.pack_coeff3d(jnp.asarray(c.reshape(ND, ND, 3, 3, 3, NZ, NY, NX))),
        pk(d), pk(b), jps.pack_field3d(jnp.asarray(x), zpad=1),
        mode=mode, neg_resid=neg, omega=0.55, interpret=True,
    ), NZ, NY, NX))
    out = fs.fused_sweep_3d(torch.as_tensor(c), _t(d), _t(b), _t(x),
                            mode=mode, neg_resid=neg, omega=0.55)
    assert out.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 2e-6 * np.abs(ref).max()


@pytest.mark.parametrize("x0_zero", [True, False])
def test_plain_k5_full_storage_matches_kept(level, x0_zero):
    full = torch.as_tensor(_full(level))
    assert fs.is_full_storage_3d(full, ND)
    x = None if x0_zero else _t(level["x0"])
    oms = tmg.smoothing_omegas(2, 3.0)
    args = (_t(level["invd"]), _t(level["b"]), x)
    kw = dict(niter=2, want_resid=True, omega=oms)
    for got, ref in zip(fs.fused_sweeps3d(full, *args, **kw),
                        fs.fused_sweeps3d(level["kept"], *args, **kw)):
        _close(got, ref.numpy())


def test_k4_k5_argument_checks(level):
    c, d, b = level["kept"], _t(level["invd"]), _t(level["b"])
    with pytest.raises(ValueError):
        fs.fused_sweep_3d(c, d, b, None, mode="sweep")  # no iterate
    with pytest.raises(ValueError):
        fs.fused_sweep_3d(c, None, b, b, mode="sweep")  # no invd
    with pytest.raises(ValueError):
        fs.fused_sweep_3d(c, d, b, b, mode="apply")
    with pytest.raises(ValueError):
        fs.fused_sweeps3d(c, d, b, None, niter=0)
    with pytest.raises(ValueError):
        fs.fused_sweeps3d(c, d, None, None, niter=2)
    with pytest.raises(ValueError):
        fs.fused_sweeps3d(c[:14], d, b, None, niter=2)  # nd=1 storage
    with pytest.raises(ValueError):
        fs.fused_sweeps3d(c, d, b, None, niter=3, omega=(0.5, 0.6))


@pytest.mark.parametrize("sym", [True, False])
def test_k5_dispatch_rule_matches_jax_budget(sym):
    """Which smoothing calls one K5 call covers, beside the JAX package's
    rule for its single-pass kernel (a level with tz = 4): the same
    stencil-pass count, and every call the JAX kernel takes (sym storage
    within its z budget) is one K5 call here, as is every longer call and
    every call on full storage."""
    from types import SimpleNamespace

    nk = len(fs.sym_planes_3d(ND)) if sym else ND * ND * 27
    jlv = SimpleNamespace(pallas3=True, nd=ND, tz=4, coeff_lp_k=None,
                          coeff_k=np.zeros((1, nk, 8, 128), np.float32))
    lv = SimpleNamespace()
    jax_calls = 0
    for niter, x0_zero, want_resid in itertools.product(
            range(1, 7), (True, False), (True, False)):
        consumed = fs.halo_sweeps_3d(niter, x0_zero, want_resid)
        assert consumed == jps.halo_sweeps_3d(niter, x0_zero, want_resid)
        jax_fused = jmg.Level.can_fuse3d(jlv, niter, x0_zero, want_resid)
        assert jax_fused == (sym and 1 <= consumed <= min(4, jps.SWEEP3_ZEXT))
        assert tmg.Level3D.can_fuse3d(lv, niter, x0_zero, want_resid)
        jax_calls += jax_fused
    # sym storage: the calls of 1..4 stencil passes
    assert jax_calls == (15 if sym else 0)
    assert not tmg.Level3D.can_fuse3d(lv, 0, True, True)


def _level9(physics):
    a = tmg.GMGAssembler3D(9, 9, 9, 1.0, 1.0, 1.0, physics, p=3.0,
                           dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    rho = torch.as_tensor(rng.uniform(0.3, 1.0, 9 ** 3), dtype=torch.float32)
    gmg, lv0 = a.assemble(rho)
    b = torch.as_tensor(rng.standard_normal((a.nd, 9, 9, 9)),
                        dtype=torch.float32)
    return gmg, lv0, torch.where(lv0.mask, 0.0, b)


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_k5_single_pass_calls_match_per_sweep(physics):
    """Port counterpart of test_fused_multi_sweep3d_matches_per_sweep:
    one K5 call per smoothing call equals the sequence of single K4
    sweeps and residual on the same data."""
    _gmg, lv0, b = _level9(physics)
    omega = 0.6
    for niter in (2, 3):
        assert lv0.can_fuse3d(niter, True, True)
        x_f, r_f = lv0.presmooth_resid3d(b, niter, omega)
        x_s = omega * lv0.inv_diag * b
        for _ in range(niter - 1):
            x_s = lv0.sweep3d(b, x_s, omega)
        r_s = lv0.resid3d(b, x_s)
        assert float((x_f - x_s).abs().max()) < 1e-5 * float(
            x_s.abs().max())
        assert float((r_f - r_s).abs().max()) < 1e-5 * float(
            r_s.abs().max())
        assert lv0.can_fuse3d(niter, False, False)
        x_pf = lv0.postsmooth3d(b, x_f, niter, omega)
        x_ps = x_f
        for _ in range(niter):
            x_ps = lv0.sweep3d(b, x_ps, omega)
        assert float((x_pf - x_ps).abs().max()) < 1e-5 * float(
            x_ps.abs().max())


def test_gmg3d_pcg_single_pass_matches_per_sweep_solve(monkeypatch):
    """Port counterpart of
    test_gmg3d_pcg_fused_multi_matches_per_sweep_solve: the GMG-PCG solve
    through K5's calls reproduces the one through single K4 sweeps (the
    V-cycle's fallback when ``can_fuse3d`` is false)."""
    sols = []
    for per_sweep in (False, True):
        if per_sweep:
            monkeypatch.setattr(tmg.Level3D, "can_fuse3d",
                                lambda self, *a: False)
        gmg, lv0, b = _level9("elasticity")
        x, k, _ = tmg.pcg(lv0.matvec, gmg.apply, b, rtol=1e-7, maxiter=100)
        sols.append((x.numpy(), int(k)))
    (x_f, k_f), (x_s, k_s) = sols
    assert abs(k_f - k_s) <= 2
    assert np.abs(x_f - x_s).max() / np.abs(x_s).max() < 5e-4


def test_sweep3d_window_fits_a_block_up_to_its_stated_width():
    """The 3D stencil pass stages an x window of ~2 nx + 137 floats per
    plane and component in shared memory; it fits a block's 227 KiB up to
    nx = 3159 at nd = 3 and 9615 at nd = 1, the limits its wrapper states
    when it refuses a wider grid."""
    lim = 227 * 1024
    assert fs.sweep3d_smem(3, 65) == 4 * 3 * 3 * 272
    assert fs.sweep3d_smem(3, 3159) <= lim < fs.sweep3d_smem(3, 3160)
    assert fs.sweep3d_smem(1, 9615) <= lim < fs.sweep3d_smem(1, 9616)
