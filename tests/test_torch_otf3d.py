"""PyTorch port, kernel K6 and the 3D on-the-fly GMG route on CPU.

K6 (``ops/otf3d.py``) replaces the Pallas ``otf_apply_3d``: it applies
the 27-point operator, runs damped-Jacobi sweeps and residuals with the
coefficients rebuilt from the nodal density, so an ``elem_path="otf"``
hierarchy stores no coefficient planes.  On CPU tensors the wrapper runs
the plain PyTorch version, gated here against the JAX package:

* the fine ``OTFLevel`` at 9^3 (p=3, seeded rho ~ U[0.3, 1], masked
  fields, float32), nd=3 and nd=1, against the JAX ``OTFLevel`` (its
  Pallas kernel in interpret mode, as ``tests/test_pallas_otf3d.py``
  runs it): matvec to 2e-6, presmooth+resid (nu=1, 2) and postsmooth
  (nu=2) to 2e-5 of max, a bf16-operand presmooth to 1e-5;
* one V-cycle of the OTF hierarchy against the JAX OTF hierarchy's, to
  2e-5 of max;
* the slice as a whole in float64: the OTF GMG-PCG at 9^3 (rho=1, and
  p=3 with seeded rho) and 17^3 (rho=1) against the JAX package's
  assembled XLA route — the same iteration count (7 at rho=1), the
  solutions within 1e-10 relative (``solve_both`` of
  ``tests/test_torch_gmg3d.py``; the JAX package's own test holds its
  OTF route to its assembled one);
* ``attach_structured_grid(..., elem_path="otf")`` + ``solve("gmg")``
  against the JAX model's uniform-route solve, 1e-10 in float64;
* the bf16-operand smoother under flexible PCG: true residual within
  5e-6 of ||b|| (``test_otf_bf16_sweeps_converge``'s contract);
* ``convert.py`` installing a JAX OTF assembler's tables.

The JAX kernel costs 2-4 s per interpret-mode call on CPU, so it is
called about a dozen times in all.
"""

import copy
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops import pallas_otf3d as jotf

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import convert
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import otf3d

from test_torch_gmg3d import _compiled_matvecs, _problem, solve_both

import torch_threads  # noqa: F401  (one torch thread per worker)

DEV = "cpu"  # the port's entry points default to the CUDA card
N = 9


@functools.lru_cache(maxsize=None)
def _pair(physics):
    """JAX and port OTF hierarchies at N^3 on one density, float32."""
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.3, 1.0, N ** 3).astype(np.float32)
    ja = jmg.GMGAssembler3D(
        N, N, N, 1.0, 1.0, 1.0, physics, p=3.0, dtype=jnp.float32,
        nu_pre=2, nu_post=2, pallas_smooth=True, pallas_tz=4,
        pallas_asm_min=0, elem_path="otf",
    )
    ta = tmg.GMGAssembler3D(N, N, N, 1.0, 1.0, 1.0, physics, p=3.0,
                            dtype=torch.float32, device=DEV, elem_path="otf")
    gj, lj = ja.assemble(jnp.asarray(rho))
    gt, lt = ta.assemble(torch.as_tensor(rho))
    assert isinstance(lj, jmg.OTFLevel) and isinstance(lt, tmg.OTFLevel)
    b = np.where(np.asarray(lj.mask), 0.0,
                 rng.standard_normal((ta.nd, N, N, N))).astype(np.float32)
    assert np.array_equal(lt.mask.numpy(), np.asarray(lj.mask))
    return gj, lj, gt, lt, b


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("nd", [3, 1])
def test_otf_weights_match_jax(nd):
    ta = tmg.GMGAssembler3D(5, 5, 5, 2.0, 1.0, 1.0,
                            "elasticity" if nd == 3 else "poisson",
                            dtype=torch.float64, device=DEV, elem_path="otf")
    st = ta.static_levels[0]
    Kq = st.Kq.numpy()
    for ref, got in zip(jotf.otf_weights(st.op.plan, Kq, nd, 8),
                        otf3d.otf_weights(st.op.plan, Kq, nd, 8)):
        assert got.dtype == np.float64
        assert np.array_equal(got.astype(np.float32), ref)
    for t, g in zip(st.otf, otf3d.otf_weights(st.op.plan, Kq, nd, 8)):
        assert np.array_equal(t.numpy(), g)


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_plain_k6_matches_jax_otf_level(physics):
    _gj, lj, _gt, lt, b = _pair(physics)
    bj, bt = jnp.asarray(b), torch.as_tensor(b)
    assert _rel(lt.matvec(bt), lj.matvec(bj)) <= 2e-6
    om = tmg.smoothing_omegas(2, 3.0)
    for nu in (1, 2):
        xj, rj = lj.presmooth_resid3d(bj, nu, om[:nu])
        xt, rt = lt.presmooth_resid3d(bt, nu, om[:nu])
        assert _rel(xt, xj) <= 2e-5 and _rel(rt, rj) <= 2e-5
    x0 = np.asarray(xj)
    assert _rel(lt.postsmooth3d(bt, torch.as_tensor(x0), 2, om[::-1]),
                lj.postsmooth3d(bj, jnp.asarray(x0), 2, om[::-1])) <= 2e-5


def test_plain_k6_bf16_operands_match_jax():
    _gj, lj, _gt, lt, b = _pair("elasticity")
    lj, lt = copy.copy(lj), copy.copy(lt)
    lj.smoother_bf16 = lt.smoother_bf16 = True
    om = tmg.smoothing_omegas(2, 3.0)
    xj, rj = lj.presmooth_resid3d(jnp.asarray(b), 2, om)
    xt, rt = lt.presmooth_resid3d(torch.as_tensor(b), 2, om)
    assert _rel(xt, xj) <= 1e-5 and _rel(rt, rj) <= 1e-5
    # the bf16 operands really are rounded: the f32 level differs by more
    x32, _ = _pair("elasticity")[3].presmooth_resid3d(torch.as_tensor(b), 2,
                                                      om)
    assert _rel(x32, xj) > 1e-4


def test_otf_vcycle_matches_jax():
    gj, _lj, gt, _lt, b = _pair("elasticity")
    assert [type(lv).__name__ for lv in gt.levels] == [
        "OTFLevel", "OTFLevel", "Level3D"]
    assert gt.levels[-1].dense_inv is not None
    assert _rel(gt.apply(torch.as_tensor(b)), gj.apply(jnp.asarray(b))) \
        <= 2e-5


@pytest.mark.parametrize("n,case", [(9, "rho=1"), (9, "p=3 random rho"),
                                    (17, "rho=1")])
def test_otf_slice_matches_jax(n, case):
    rtol = 1e-6
    if case == "rho=1":
        p, rho = 0.0, np.ones(n ** 3)
    else:
        p, rho = 3.0, np.random.default_rng(2).uniform(0.3, 1.0, n ** 3)
    (x_ref, k_ref), (x, k, rn, bn) = solve_both(n, p, rho, rtol,
                                                elem_path="otf")
    if case == "rho=1":
        assert k_ref == 7
    assert k == k_ref
    assert rn <= rtol * bn
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


def test_model_entry_otf_matches_jax():
    n = 5
    conn, X, fixed, force, _L = _problem(n)
    rho = np.random.default_rng(7).uniform(0.3, 1.0, n ** 3)
    jm = fem.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0)
    jm.attach_structured_grid(n, n, n)
    _compiled_matvecs(st[0] for st in jm._gmg_asm.static_levels)
    with jax.disable_jit():
        u_ref = np.asarray(jm.solve(method="gmg", rho=rho, rtol=1e-10))
    tm = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                             dtype=torch.float64, device=DEV)
    tm.attach_structured_grid(n, n, n, elem_path="otf")
    assert tm._gmg_asm.elem_path == "otf"
    u = tm.solve(method="gmg", rho=rho, rtol=1e-10)
    assert tm.last_solve_stats["iters"] > 0
    assert np.abs(u.numpy() - u_ref).max() <= 1e-10 * np.abs(u_ref).max()


def test_otf_bf16_flexible_pcg_converges():
    ta = tmg.GMGAssembler3D(N, N, N, 1.0, 1.0, 1.0, "elasticity", p=3.0,
                            dtype=torch.float32, device=DEV, elem_path="otf",
                            smoother_dtype=torch.bfloat16, omega="cheby")
    rng = np.random.default_rng(3)
    gmg, lv0 = ta.assemble(torch.as_tensor(
        rng.uniform(0.3, 1.0, N ** 3), dtype=torch.float32))
    assert lv0.smoother_bf16
    b = torch.where(lv0.mask, 0.0, torch.as_tensor(
        rng.standard_normal((3, N, N, N)), dtype=torch.float32))
    x, k, rn = tmg.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=100,
                           flexible=True)
    nb = float(torch.linalg.norm(b))
    assert 0 < k < 100 and float(rn) <= 1e-6 * nb
    assert float(torch.linalg.norm(b - lv0.matvec(x))) <= 5e-6 * nb


def test_convert_installs_jax_otf_tables():
    ja = jmg.GMGAssembler3D(N, N, N, 2.0, 1.0, 1.0, "elasticity", p=3.0,
                            dtype=jnp.float32, pallas_smooth=True,
                            pallas_tz=4, elem_path="otf")
    ta = tmg.GMGAssembler3D(N, N, N, 2.0, 1.0, 1.0, "elasticity", p=3.0,
                            dtype=torch.float32, device=DEV, elem_path="otf")
    rho = torch.as_tensor(np.random.default_rng(4).uniform(0.3, 1.0, N ** 3),
                          dtype=torch.float32)
    own, lv0 = ta.assemble(rho)
    u = torch.where(lv0.mask, 0.0, torch.as_tensor(
        np.random.default_rng(5).standard_normal((3, N, N, N)),
        dtype=torch.float32))
    Kq = [np.asarray(st[5]) for st in ja.static_levels]
    masks = [np.asarray(st[3]) for st in ja.static_levels]
    otf = [st[7] for st in ja.static_levels]
    assert [o is None for o in otf] == [st.otf is None
                                        for st in ta.static_levels]
    convert.assembler_state_from_numpy(ta, Kq, masks, otf=otf, sym=True)
    got, lg0 = ta.assemble(rho)
    for a, b, o in zip(own.levels, got.levels, otf):
        if o is not None:
            assert torch.equal(a.w3, b.w3) and torch.equal(a.wd, b.wd)
            assert np.array_equal(b.w3.numpy(), np.asarray(o[0]))
    assert torch.equal(lv0.matvec(u), lg0.matvec(u))
    assert torch.equal(own.apply(u), got.apply(u))
    with pytest.raises(ValueError):
        convert.assembler_state_from_numpy(ta, Kq, masks, otf=[None] * 3)


def test_k6_wrapper_and_argument_checks():
    _gj, _lj, _gt, lt, b = _pair("poisson")
    args = (lt.rho, lt.maskf, lt.w3, lt.wd)
    bt = torch.as_tensor(b)
    kw = dict(niter=2, want_resid=True, omega=0.5, p=3.0)
    got = otf3d.otf_apply_3d(*args, bt, None, **kw)
    ref = otf3d.otf_apply_3d_plain(*args, bt, None, **kw)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    # matvec = -(residual with b = 0); the x0 = 0 first sweep is omega*invd*b
    mv = otf3d.otf_apply_3d(*args, None, bt, niter=0, neg_resid=True, p=3.0)
    assert torch.allclose(mv, -otf3d.otf_apply_3d(*args, None, bt, niter=0,
                                                  p=3.0))
    x1 = otf3d.otf_apply_3d(*args, bt, None, niter=1, want_resid=False,
                            omega=0.5, p=3.0)
    assert torch.equal(x1 == 0, lt.mask | (bt == 0))
    for bad in (
        lambda: otf3d.otf_apply_3d(*args, bt, None, niter=0),  # no x
        lambda: otf3d.otf_apply_3d(*args, None, None, niter=2),  # no b
        lambda: otf3d.otf_apply_3d(*args, None, bt, niter=0,
                                   want_resid=False),
        lambda: otf3d.otf_apply_3d(args[0], args[1], args[2][..., :3],
                                   args[3], bt, None, niter=1),
        lambda: otf3d.otf_apply_3d(*args, bt.double(), None, niter=1),
    ):
        with pytest.raises(ValueError):
            bad()
    assert lt.can_fuse3d(6, True, True) and not lt.can_fuse3d(0, True, True)
    # the tensor-core body's weights: every nonzero weight of w3 once, in
    # bf16, the contraction zero-padded
    w3t = otf3d.tc_table(lt.w3)
    assert w3t.dtype == torch.bfloat16 and tuple(w3t.shape) == (1, 8, 8, 24)
    assert not w3t[..., 8:].any()
    w3b = lt.w3.to(torch.bfloat16)
    assert int((w3t != 0).sum()) == int((w3b != 0).sum())
    assert torch.allclose(w3t.double().abs().sum(), w3b.double().abs().sum())
    # the card's tables are built once per (w3, wd), again after a change
    w3, wd = lt.w3.clone(), lt.wd.clone()
    tabs = otf3d._device_tables(w3, wd, True)
    assert otf3d._device_tables(w3, wd, True) is tabs
    assert torch.equal(tabs[0], w3t)
    w3.mul_(2.0)
    assert torch.equal(otf3d._device_tables(w3, wd, True)[0], 2 * w3t)
