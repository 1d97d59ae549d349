"""PyTorch port, kernel K2 (``ops/fused_smooth.py``) on CPU.

K2 replaces the Pallas ``fused_sweeps_2d``; on a CPU tensor its wrapper
runs the plain PyTorch version.  Gated here in float64 to 1e-12
relative, on a JAX-assembled level (``Stencil2D.bc_eliminate`` planes),
against sweeps built from the JAX ``Stencil2D.matvec``, in the four
variants the V-cycle calls plus a long ``niter=8`` run:

* presmooth + residual on the bf16 coefficient copy (x0 = 0);
* postsmooth on the bf16 copy;
* postsmooth + residual on the full-precision planes;
* ``niter=0`` negated residual with b = 0, i.e. the matvec.

The bf16 variants read identical bf16-rounded coefficients on both
sides.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import multigrid as jmg

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

torch.set_num_threads(2)

NX, NY = 33, 17


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(0)
    rho = rng.uniform(0.2, 1.0, NY * NX)
    ja = jmg.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                          dtype=jnp.float64)
    op, _xe, _conn, mask, _shape, Kq, _pal = ja.static_levels[0]

    @jax.jit
    def planes(rho):
        coeff = op.assemble_uniform(
            ja.material_planes(rho.reshape(NY, NX)), Kq
        )
        ce = op.bc_eliminate(coeff, mask)
        d = op.diagonal(ce)
        return ce, 1.0 / jnp.where(d == 0, 1.0, d)

    ce, invd = planes(jnp.asarray(rho))
    mv = jax.jit(op.matvec)
    mask = np.asarray(mask)
    b = np.where(mask, 0.0, rng.standard_normal((2, NY, NX)))
    x0 = np.where(mask, 0.0, rng.standard_normal((2, NY, NX)))
    return dict(ce=np.array(ce), invd=np.array(invd), mv=mv, b=b,
                x0=x0, xr=rng.standard_normal((2, NY, NX)))


def _ref(lv, ce, b, x, oms, want_resid, neg=False):
    """Jacobi sweeps + residual with the JAX stencil matvec."""
    mv = lambda c, u: np.asarray(lv["mv"](jnp.asarray(c), jnp.asarray(u)))
    bb = np.zeros_like(lv["invd"]) if b is None else b
    for om in oms:
        ax = 0.0 if x is None else mv(ce, x)
        x = (0.0 if x is None else x) + om * lv["invd"] * (bb - ax)
    r = None
    if want_resid:
        r = bb - mv(ce, x)
        r = -r if neg else r
    return x, r


def _close(got, ref):
    assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


_OM2 = tmg.smoothing_omegas(2, 2.3)
_VARIANTS = {
    # name: (bf16 coeff, b?, x given, niter, want_resid, neg, omegas)
    "presmooth_resid_bf16": (True, True, False, 2, True, False, _OM2),
    "postsmooth_bf16": (True, True, True, 2, False, False, _OM2[::-1]),
    "postsmooth_resid": (False, True, True, 2, True, False, _OM2[::-1]),
    "matvec": (False, False, "raw", 0, True, True, 0.7),
    "niter8": (False, True, False, 8, True, False,
               tmg.smoothing_omegas(8, 2.3)),
}


@pytest.mark.parametrize("name", list(_VARIANTS))
def test_plain_k2_matches_jax_sweeps(level, name):
    lp, with_b, xg, niter, want_resid, neg, omega = _VARIANTS[name]
    ce = level["ce"]
    c_t = torch.as_tensor(ce.reshape(-1, NY, NX))
    if lp:
        c_t = c_t.to(torch.bfloat16)
        ce = c_t.double().numpy().reshape(ce.shape)  # identical values
    b = level["b"] if with_b else None
    x = {False: None, True: level["x0"], "raw": level["xr"]}[xg]
    oms = fs._omega_seq(omega, niter)
    x_ref, r_ref = _ref(level, ce, b, x, oms, want_resid, neg)
    t = lambda a: None if a is None else torch.as_tensor(a)
    out = fs.fused_sweeps_2d(
        c_t, t(level["invd"]), t(b), t(x), niter=niter,
        want_resid=want_resid, neg_resid=neg, omega=omega,
    )
    if niter > 0 and want_resid:
        _close(out[0], x_ref)
        _close(out[1], r_ref)
    elif niter > 0:
        _close(out, x_ref)
    else:
        _close(out, r_ref)


def test_k2_argument_checks(level):
    c = torch.as_tensor(level["ce"].reshape(-1, NY, NX))
    d = torch.as_tensor(level["invd"])
    with pytest.raises(ValueError):
        fs.fused_sweeps_2d(c, d, None, None, niter=2)
    with pytest.raises(ValueError):
        fs.fused_sweeps_2d(c, d, d, None, niter=3, omega=(0.5, 0.6))
    with pytest.raises(ValueError):
        fs.fused_sweeps_2d(c[:9], d, d, None, niter=1)
    # any niter is accepted: no ghost-row budget on the per-sweep design
    x = fs.fused_sweeps_2d(c, d, d, None, niter=12, omega=0.5)
    assert torch.isfinite(x).all()
