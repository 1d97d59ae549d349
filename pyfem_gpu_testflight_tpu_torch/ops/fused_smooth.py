"""K2: damped-Jacobi sweeps (+ residual) on BC-eliminated stencil planes.

Port of ``fused_sweeps_2d`` / ``_omega_seq`` from
``pyfem_gpu_testflight_tpu/ops/pallas_smooth.py``.  Runs

    x <- x + omega_i * invD * (b - A x)

``niter`` times, then optionally returns ``±(b - A x)``; ``niter=0``
with ``neg_resid=True`` and ``b=None`` is the operator matvec.  The
coefficients are the BC-eliminated planes of ``fused_assemble`` (so the
matvec is select-free) in the logical layout ``(nd*nd*9, ny, nx)``, as
float32 or bfloat16 (loaded as bf16, arithmetic in the field dtype);
fields are ``(nd, ny, nx)`` and zero at fixed dofs (the V-cycle
invariant).  A first sweep from ``x = None`` (x0 = 0) is elementwise
and consumes ``omega[0]``.

The TPU kernel fused all sweeps into one pass over the coefficients
and so had a ghost-row budget of 7 sweeps; here each sweep is its own
launch of ``csrc/smooth_2d.cu`` and any ``niter >= 0`` is accepted.

A CPU tensor takes :func:`fused_sweeps_2d_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _cuda
from .stencil import Stencil2D

__all__ = ["fused_sweeps_2d", "fused_sweeps_2d_plain"]

_MODE_SWEEP, _MODE_RESID, _MODE_NEG_RESID = 0, 1, 2


def _omega_seq(omega, niter):
    """Per-sweep damping tuple of length ``niter``.

    A scalar replicates (stationary damped Jacobi); a tuple/list gives
    one factor per sweep (nonstationary Richardson — e.g. Chebyshev
    nodes, see multigrid.smoothing_omegas).
    """
    if isinstance(omega, (tuple, list)):
        seq = tuple(float(w) for w in omega)
        if len(seq) < niter:
            raise ValueError(f"{len(seq)} omegas for {niter} sweeps")
        return seq[:niter]
    return (float(omega),) * niter


def _check(coeff, invd, b, x, niter, want_resid):
    if x is None and b is None:
        raise ValueError("b and x cannot both be zero (None)")
    if x is None and niter == 0:
        raise ValueError("niter=0 needs an iterate x")
    if niter == 0 and not want_resid:
        raise ValueError("niter=0 without want_resid computes nothing")
    nd, ny, nx = invd.shape
    if tuple(coeff.shape) != (nd * nd * 9, ny, nx):
        raise ValueError(
            f"coeff {tuple(coeff.shape)} != {(nd * nd * 9, ny, nx)}"
        )
    for name, t in (("b", b), ("x", x)):
        if t is not None and (t.shape != invd.shape or t.dtype != invd.dtype
                              or t.device != invd.device):
            raise ValueError(f"{name} must match invd's shape/dtype/device")
    if coeff.device != invd.device:
        raise ValueError("coeff and invd on different devices")


def _outputs(x, r, niter, want_resid):
    if niter > 0 and want_resid:
        return x, r
    return x if niter > 0 else r


def fused_sweeps_2d_plain(coeff, invd, b=None, x=None, *, niter=2,
                          want_resid=False, neg_resid=False, omega=0.7):
    """Plain PyTorch K2 (any device); same contract as fused_sweeps_2d."""
    _check(coeff, invd, b, x, niter, want_resid)
    nd, ny, nx = invd.shape
    op = Stencil2D(nx, ny, nd)
    c = coeff.to(invd.dtype).reshape(nd, nd, 3, 3, ny, nx)
    oms = _omega_seq(omega, niter)
    zero = torch.zeros_like(invd)
    bb = zero if b is None else b
    for om in oms:
        ax = zero if x is None else op.matvec(c, x)
        r = bb - ax
        x = (zero if x is None else x) + om * invd * r
    r = None
    if want_resid:
        r = bb - op.matvec(c, x)
        if neg_resid:
            r = -r
    return _outputs(x, r, niter, want_resid)


def _fused_sweeps_2d_cuda(coeff, invd, b, x, *, niter, want_resid,
                          neg_resid, omega):
    _check(coeff, invd, b, x, niter, want_resid)
    if invd.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32 fields, got "
                        f"{invd.dtype}")
    if coeff.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coefficients must be float32 or bfloat16, got "
                        f"{coeff.dtype}")
    for t in (coeff, invd, b, x):
        if t is not None and not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    nd, ny, nx = invd.shape
    bf16 = int(coeff.dtype == torch.bfloat16)
    stream = _cuda.stream_ptr(invd)
    ptr = lambda t: None if t is None else t.data_ptr()

    def step(xin, out, om, mode):
        _cuda.launch("pyfem_smooth_2d", coeff.data_ptr(), bf16,
                     invd.data_ptr(), ptr(b), ptr(xin), out.data_ptr(),
                     nd, ny, nx, float(om), mode, stream)

    # ping-pong: a sweep reads every neighbour of its input, so it can
    # never write in place; the caller's x is never written
    bufs = [torch.empty_like(invd) for _ in range(min(niter, 2))]
    for i, om in enumerate(_omega_seq(omega, niter)):
        out = bufs[i % 2]
        step(x, out, om, _MODE_SWEEP)
        x = out
    r = None
    if want_resid:
        r = torch.empty_like(invd)
        step(x, r, 0.0, _MODE_NEG_RESID if neg_resid else _MODE_RESID)
    return _outputs(x, r, niter, want_resid)


def fused_sweeps_2d(coeff, invd, b=None, x=None, *, niter=2,
                    want_resid=False, neg_resid=False, omega=0.7):
    """Damped-Jacobi sweeps (+ optional residual) on stencil planes.

    Args:
        coeff: (nd*nd*9, ny, nx) BC-eliminated planes, f32 or bf16.
        invd: (nd, ny, nx) inverse diagonal (0 at fixed dofs).
        b: (nd, ny, nx) rhs, or None for b = 0.
        x: (nd, ny, nx) initial iterate, or None for x0 = 0.
        niter: number of Jacobi sweeps (0 = matvec/residual only).
        want_resid: also return sign*(b - A x_final).
        neg_resid: flip the residual sign (A x - b).
        omega: a damping factor, or a tuple of per-sweep factors
            (len >= niter).

    Returns:
        x_out, r_out, or (x_out, r_out), per niter/want_resid.
    """
    kw = dict(niter=int(niter), want_resid=want_resid,
              neg_resid=neg_resid, omega=omega)
    if invd.device.type == "cuda":
        return _fused_sweeps_2d_cuda(coeff, invd, b, x, **kw)
    if invd.device.type == "cpu":
        return fused_sweeps_2d_plain(coeff, invd, b, x, **kw)
    raise ValueError(f"unsupported device {invd.device}")
