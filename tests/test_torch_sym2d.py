"""PyTorch port, the half-symmetric 2D storage of K1 and K2 on CPU.

K1-sym and K2-sym replace the Pallas ``assemble_pack_2d(sym=True)`` and
the ``sym_list`` body of ``fused_sweeps_2d``: 19 of 36 planes at nd=2,
5 of 9 at nd=1, the partner plane read as the kept one shifted.  On CPU
tensors the wrappers run the plain versions.  Gated in float64 against
the JAX package's XLA path:

* ``sym_planes_2d`` is the JAX list;
* K1-sym's planes are the JAX ``Stencil2D.assemble_uniform`` +
  ``bc_eliminate`` planes at the kept indices (1e-12), and
  ``full_planes_2d`` rebuilds the JAX full planes from them (1e-12);
* K2-sym in every mode equals Jacobi sweeps built from the JAX
  ``Stencil2D.matvec`` on full planes (1e-12);
* a ``sym=True`` GMG-PCG solve takes the JAX full-storage XLA solve's
  iteration count, its solution within 1e-10; on the element-matrix
  routes (``elem_path="einsum" | "cuda"``) ``sym=True`` keeps the same
  planes and gives the full-storage solve.

The kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.pallas_smooth import (
    sym_planes_2d as j_sym_planes_2d,
)

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

torch.set_num_threads(2)

NX, NY = 33, 17
TOL = 1e-12
_PHYS = {2: "elasticity", 1: "poisson"}


def _close(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def _rebuild_full(kept, nd):
    """Independent NumPy rebuild of full planes from the kept ones."""
    ny, nx = kept.shape[1:]
    full = np.zeros((nd, nd, 3, 3, ny, nx))
    kp = np.pad(kept, ((0, 0), (1, 1), (1, 1)))
    for si, (_k, a, b, dy, dx, selfp) in enumerate(j_sym_planes_2d(nd)):
        full[a, b, dy, dx] = kept[si]
        if not selfp:
            # partner at node j: the kept value at j - (d - 1)
            full[b, a, 2 - dy, 2 - dx] = kp[si, 2 - dy:2 - dy + ny,
                                            2 - dx:2 - dx + nx]
    return full


@pytest.fixture(scope="module", params=[2, 1], ids=["nd2", "nd1"])
def level(request):
    nd = request.param
    rng = np.random.default_rng(nd)
    rho = rng.uniform(0.2, 1.0, NY * NX)
    ja = jmg.GMGAssembler(NX, NY, 2.0, 1.0, _PHYS[nd], p=3.0,
                          dtype=jnp.float64)
    op, _xe, _conn, mask, _shape, Kq, _pal = ja.static_levels[0]

    @jax.jit
    def planes(rho):
        coeff = op.assemble_uniform(
            ja.material_planes(rho.reshape(NY, NX)), Kq)
        ce = op.bc_eliminate(coeff, mask)
        d = op.diagonal(ce)
        return ce, jnp.where(jnp.asarray(mask), 0.0,
                             1.0 / jnp.where(d == 0, 1.0, d))

    ce, invd = planes(jnp.asarray(rho))
    mask = np.asarray(mask)
    f = lambda: np.where(mask, 0.0, rng.standard_normal((nd, NY, NX)))
    return dict(nd=nd, rho=rho, ce=np.array(ce), invd=np.array(invd),
                mv=jax.jit(op.matvec), b=f(), x0=f(),
                xr=rng.standard_normal((nd, NY, NX)))


def test_sym_planes_2d_is_the_jax_list():
    for nd, n in ((2, 19), (1, 5)):
        assert fs.sym_planes_2d(nd) == j_sym_planes_2d(nd)
        assert len(fs.sym_planes_2d(nd)) == n


def test_k1_sym_plain_matches_jax_kept_planes(level):
    nd = level["nd"]
    a = tmg.GMGAssembler(NX, NY, 2.0, 1.0, _PHYS[nd], p=3.0,
                         dtype=torch.float64, device="cpu")
    st = a.static_levels[0]
    rho = torch.as_tensor(level["rho"]).reshape(NY, NX)
    coeff, invd, lp = fa.assemble_pack_2d(rho, st.maskf, st.W, a.N, nd=nd,
                                          p=3.0, lp_dtype=torch.bfloat16,
                                          sym=True)
    kept = [k for (k, *_r) in fs.sym_planes_2d(nd)]
    ref = level["ce"].reshape(nd * nd * 9, NY, NX)[kept]
    assert coeff.shape == (len(kept), NY, NX)
    _close(coeff, ref)
    _close(invd, level["invd"])
    assert torch.equal(lp, coeff.to(torch.bfloat16))
    # both rebuilds of the full planes give the JAX full planes
    _close(fs.full_planes_2d(coeff, nd), level["ce"])
    _close(_rebuild_full(ref, nd), level["ce"])


_OM2 = tmg.smoothing_omegas(2, 2.3)
_VARIANTS = {
    # name: (bf16 coeff, b?, x given, niter, want_resid, neg, omegas)
    "presmooth_resid_bf16": (True, True, False, 2, True, False, _OM2),
    "postsmooth_bf16": (True, True, True, 2, False, False, _OM2[::-1]),
    "postsmooth_resid": (False, True, True, 2, True, False, _OM2[::-1]),
    "resid": (False, True, "raw", 0, True, False, 0.7),
    "matvec": (False, False, "raw", 0, True, True, 0.7),
    "niter8": (False, True, False, 8, True, False,
               tmg.smoothing_omegas(8, 2.3)),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_k2_sym_plain_matches_full_storage_sweeps(level, name):
    lp, with_b, xg, niter, want_resid, neg, omega = _VARIANTS[name]
    nd = level["nd"]
    kept = [k for (k, *_r) in fs.sym_planes_2d(nd)]
    c_t = torch.as_tensor(level["ce"].reshape(-1, NY, NX)[kept])
    if lp:
        c_t = c_t.to(torch.bfloat16)
    # reference planes: the kept values (bf16-rounded where the smoother
    # reads bf16) rebuilt to full storage without the port
    full = _rebuild_full(c_t.double().numpy(), nd)
    mv = lambda u: np.asarray(level["mv"](jnp.asarray(full), jnp.asarray(u)))
    b = level["b"] if with_b else None
    x = {False: None, True: level["x0"], "raw": level["xr"]}[xg]
    bb = np.zeros_like(level["invd"]) if b is None else b
    xr = x
    for om in fs._omega_seq(omega, niter):
        ax = 0.0 if xr is None else mv(xr)
        xr = (0.0 if xr is None else xr) + om * level["invd"] * (bb - ax)
    r_ref = None
    if want_resid:
        r_ref = bb - mv(xr)
        r_ref = -r_ref if neg else r_ref
    t = lambda a: None if a is None else torch.as_tensor(a)
    out = fs.fused_sweeps_2d(c_t, t(level["invd"]), t(b), t(x), niter=niter,
                             want_resid=want_resid, neg_resid=neg,
                             omega=omega)
    if niter > 0 and want_resid:
        _close(out[0], xr)
        _close(out[1], r_ref)
    elif niter > 0:
        _close(out, xr)
    else:
        _close(out, r_ref)


@pytest.mark.parametrize("nd", [2, 1])
def test_sym_gmg_solve_matches_jax_full_storage(nd):
    rtol = 1e-11
    rho = np.random.default_rng(10 + nd).uniform(0.3, 1.0, NY * NX)
    rhs = np.random.default_rng(20 + nd).standard_normal((nd, NY, NX))
    ja = jmg.GMGAssembler(NX, NY, 2.0, 1.0, _PHYS[nd], p=3.0,
                          dtype=jnp.float64, omega="cheby")

    @jax.jit
    def forward(rho, rhs):
        gmg, lv0 = ja.assemble(rho)
        b = jnp.where(lv0.mask, 0.0, rhs)
        return jmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100)

    x_ref, k_ref, _ = forward(jnp.asarray(rho), jnp.asarray(rhs))
    ta = tmg.GMGAssembler(NX, NY, 2.0, 1.0, _PHYS[nd], p=3.0,
                          dtype=torch.float64, omega="cheby", device="cpu",
                          sym=True)
    gmg, lv0 = ta.assemble(torch.as_tensor(rho))
    assert lv0.coeff.shape[0] == len(fs.sym_planes_2d(nd))
    b = torch.where(lv0.mask, 0.0, torch.as_tensor(rhs))
    x, k, rn = tmg.pcg_gmg(gmg, lv0, b, rtol=rtol, maxiter=100)
    assert k == int(k_ref)
    assert float(rn) <= rtol * float(torch.linalg.norm(b))
    err = np.abs(x.numpy() - np.asarray(x_ref)).max()
    assert err <= 1e-10 * np.abs(np.asarray(x_ref)).max()


@pytest.mark.parametrize("elem_path", ["einsum", "cuda"])
def test_sym_storage_on_element_paths_matches_full(elem_path):
    """``sym=True`` on the element-matrix routes keeps the planes the
    uniform route keeps; the solve equals the full-storage one."""
    rho = torch.as_tensor(np.random.default_rng(5).uniform(0.3, 1.0,
                                                            NY * NX))
    out = {}
    for sym in (False, True):
        ta = tmg.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                              dtype=torch.float64, device="cpu",
                              elem_path=elem_path, sym=sym)
        gmg, lv0 = ta.assemble(rho)
        b = torch.where(lv0.mask, 0.0, torch.ones(2, NY, NX,
                                                  dtype=torch.float64))
        out[sym] = (lv0.coeff, tmg.pcg_gmg(gmg, lv0, b, rtol=1e-10,
                                           maxiter=100))
    kept = [k for (k, *_r) in fs.sym_planes_2d(2)]
    _close(out[True][0], out[False][0][kept])
    assert out[True][1][1] == out[False][1][1]
    _close(out[True][1][0], out[False][1][0])
