"""K6: the 3D stencil apply and damped-Jacobi sweeps with no stored
coefficients (on-the-fly, "OTF").

Port of ``pyfem_gpu_testflight_tpu/ops/pallas_otf3d.py`` (``otf_weights``,
``otf_apply_3d``).  On a uniform grid the BC-eliminated 27-point
coefficient at node i factors through the quadrature unit matrices:

    coeff[(ca, cb, d)][i] = rowm_ca[i] * colm_cb_d[i] *
                            sum_j W[(ca, cb, d), j] * B_j[i]  (+ diag fix)

with ``B_j[i] = RAMP(N_q . rho)[element i - o]``, j = (o, q) over the 8
element offsets x 8 quadrature points (``fused_assemble.
shifted_materials_3d``).  With fields that are zero at fixed dofs (the
V-cycle and PCG invariant, and the precondition of every call here)
``colm`` folds into x and the operator becomes

    A x [ca] = rowm_ca * sum_j B_j * Z_j^ca + (1 - rowm_ca) * x[ca],
    Z^ca = w3[ca] @ Y,    Y_m[i] = x[cb][i + d - 1]  (0 off the grid)

so each call rebuilds the coefficients from the density instead of
reading a coefficient volume.  The inverse diagonal is
``rowm / (rowm * (wd . B) + 1 - rowm)``, 0 at fixed dofs.

``mxu_bf16=True`` (the smoother's calls under flexible PCG) rounds the
TPU kernel's matmul operands to bfloat16 — ``w3``, the shifted fields
``Y``, and ``wd`` and ``B`` in the diagonal — and keeps every product,
sum and the final ``B * Z`` contraction in float32 (a bf16 x bf16
product is exact in f32).  The matvec of the PCG operator is always
float32.

Layouts are logical: density ``(nz, ny, nx)``, free mask and fields
``(nd, nz, ny, nx)``.  The TPU z-tiling, its ghost-plane budget
(``otf_budget_ok``, ``pallas_tz``) and packed layouts are not ported: the
kernel runs one launch per stencil pass, so any number of sweeps works.

A CPU tensor takes the ``*_plain`` version; a CUDA tensor launches
``csrc/otf_3d.cu`` or raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda
from .fused_assemble import assembly_weights3d, shifted_materials_3d
from .fused_smooth import _MODE_NEG_RESID, _MODE_RESID, _MODE_SWEEP, _omega_seq

__all__ = ["otf_weights", "otf_apply_3d", "otf_apply_3d_plain", "tc_table",
           "f32_table"]


def otf_weights(plan, Kq, nd, nq):
    """Host: the OTF weight tables (float64) from the Stencil3D plan.

    Returns:
        w3: (nd, 8*nq, 27*nd), ``Z^ca = w3[ca] @ Y``.
        wd: (nd, 8*nq), ``diag[ca] = rowm * (wd[ca] . B) + (1 - rowm)``.
    """
    W = assembly_weights3d(plan, Kq, nd, nq)  # (nd*nd*27, 8, nq)
    W2 = W.reshape(nd, nd * 27, 8 * nq)
    w3 = np.ascontiguousarray(np.swapaxes(W2, 1, 2))
    wd = np.stack([W2[ca, ca * 27 + 13] for ca in range(nd)])
    return w3, wd


_HEX8_N = {}


def _shape_vals(ref):
    """hex8 shape values at the quad points, in ref's dtype and device."""
    key = (ref.dtype, ref.device)
    if key not in _HEX8_N:
        from ..elements import get_element

        _HEX8_N[key] = torch.as_tensor(
            get_element("hex8").shape_vals, dtype=ref.dtype, device=ref.device
        ).contiguous()
    return _HEX8_N[key]


def _bf16(t):
    """Round to bfloat16, back in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _check(rho, maskf, w3, wd, b, x, niter, want_resid):
    if x is None and niter == 0:
        raise ValueError("niter=0 needs an iterate x")
    if niter > 0 and b is None:
        raise ValueError("sweeps need b")
    if niter == 0 and not want_resid:
        raise ValueError("niter=0 without want_resid computes nothing")
    if rho.dim() != 3 or maskf.dim() != 4:
        raise ValueError("want rho (nz, ny, nx) and maskf (nd, nz, ny, nx)")
    nd = maskf.shape[0]
    if nd not in (1, 3) or tuple(maskf.shape[1:]) != tuple(rho.shape):
        raise ValueError(f"maskf {tuple(maskf.shape)} does not fit rho "
                         f"{tuple(rho.shape)} with nd 1 or 3")
    if tuple(w3.shape) != (nd, 64, 27 * nd) or tuple(wd.shape) != (nd, 64):
        raise ValueError(f"w3 {tuple(w3.shape)} / wd {tuple(wd.shape)}: want "
                         f"({nd}, 64, {27 * nd}) / ({nd}, 64)")
    for name, t in (("maskf", maskf), ("w3", w3), ("wd", wd), ("b", b),
                    ("x", x)):
        if t is not None and (t.dtype != rho.dtype or t.device != rho.device):
            raise ValueError(f"{name} must be {rho.dtype} on {rho.device}")
    for name, t in (("b", b), ("x", x)):
        if t is not None and t.shape != maskf.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != "
                             f"{tuple(maskf.shape)}")
    return nd


def _outputs(x, r, niter, want_resid):
    if niter > 0 and want_resid:
        return x, r
    return x if niter > 0 else r


def otf_apply_3d_plain(rho, maskf, w3, wd, b=None, x=None, *, niter=0,
                       want_resid=True, neg_resid=False, omega=0.6, p=0.0,
                       mxu_bf16=False):
    """Plain PyTorch K6 (any device, any float dtype); same contract as
    :func:`otf_apply_3d`, computed as the TPU kernel does (``Z = w3 @
    Y``, then ``sum_j B_j Z_j``)."""
    niter = int(niter)
    nd = _check(rho, maskf, w3, wd, b, x, niter, want_resid)
    nz, ny, nx = rho.shape
    B = shifted_materials_3d(rho, _shape_vals(rho), p).reshape(64, -1)
    rnd = _bf16 if mxu_bf16 else (lambda t: t)
    w3m = rnd(w3)

    def apply(xv):
        xp = F.pad(rnd(xv), (1, 1, 1, 1, 1, 1))
        Y = torch.stack([
            xp[cb, dz : dz + nz, dy : dy + ny, dx : dx + nx]
            for cb in range(nd) for dz in range(3) for dy in range(3)
            for dx in range(3)
        ]).reshape(27 * nd, -1)
        acc = torch.stack([(B * (w3m[ca] @ Y)).sum(0) for ca in range(nd)])
        return maskf * acc.reshape(maskf.shape) + (1.0 - maskf) * xv

    if niter > 0:
        dm = (rnd(wd) @ rnd(B)).reshape(maskf.shape)
        d = maskf * dm + (1.0 - maskf)
        invd = maskf / torch.where(d == 0.0, 1.0, d)
    for om in _omega_seq(omega, niter):
        if x is None:  # first sweep from x0 = 0: elementwise
            x = om * invd * b
        else:
            x = x + om * invd * (b - apply(x))
    r = None
    if want_resid:
        ax = apply(x)
        r = -ax if b is None else b - ax
        if neg_resid:
            r = -r
    return _outputs(x, r, niter, want_resid)


_TC_INDEX = {}


def _tc_index(nd, device):
    """Flat w3 indices of the per-offset tables (``tc_table``,
    ``f32_table``), (nd, 8 o, 8 q, 8 nd):
    for element offset o and quad point q, the weight of component cb at
    the element's node m (m = mz*4 + my*2 + mx), which is the neighbour
    d - 1 = m - o of the node; the other weights of w3 are zero by the
    stencil plan."""
    key = (nd, device)
    if key not in _TC_INDEX:
        idx = np.empty((nd, 8, 8, 8 * nd), np.int64)
        for ca, o, q, cb, m in np.ndindex(nd, 8, 8, nd, 8):
            dz = (m >> 2) - (o >> 2) + 1
            dy = ((m >> 1) & 1) - ((o >> 1) & 1) + 1
            dx = (m & 1) - (o & 1) + 1
            idx[ca, o, q, cb * 8 + m] = ((ca * 64 + o * 8 + q) * 27 * nd
                                         + cb * 27 + dz * 9 + dy * 3 + dx)
        _TC_INDEX[key] = torch.as_tensor(idx, device=device)
    return _TC_INDEX[key]


def tc_table(w3):
    """The tensor-core body's weights: the structurally nonzero ones of
    ``w3`` (nd, 64, 27 nd), rounded to bf16, as (nd, 8 o, 8 q, ks) —
    the contraction 8 nd zero-padded to a multiple of 16 plus 8
    (``csrc/otf_3d.cu`` ``TcShape``: a row stride whose fragment loads
    hit distinct shared-memory banks)."""
    nd = w3.shape[0]
    k = 8 * nd
    out = w3.new_zeros((nd, 8, 8, -(-k // 16) * 16 + 8), dtype=torch.bfloat16)
    out[..., :k] = w3.reshape(-1)[_tc_index(nd, w3.device)]
    return out


def f32_table(w3):
    """The f32 body's weights: the structurally nonzero ones of ``w3``
    (nd, 64, 27 nd) as (8 o, 8 nd k, 4 l, ws) in w3's dtype, k = (cb, m)
    over the 8 nodes m of the element node - o, entry (ca, qq) = ca * 2 +
    qq holding the weight of quad point q = 2 l + qq, zero-padded to ws =
    2 nd rounded up to 4 (``csrc/otf_3d.cu`` ``otf_3d_kernel``: lane l of
    a quad of threads reads its 2 nd weights of (o, k) as float4s)."""
    nd = w3.shape[0]
    t = w3.reshape(-1)[_tc_index(nd, w3.device)]  # (ca, o, q, k)
    t = t.reshape(nd, 8, 4, 2, 8 * nd).permute(1, 4, 2, 0, 3)
    out = w3.new_zeros((8, 8 * nd, 4, -(-2 * nd // 4) * 4))
    out[..., :2 * nd] = t.reshape(8, 8 * nd, 4, 2 * nd)
    return out


_TABLES = {}


def _device_tables(w3, wd, bf16):
    """The kernels' weight tables, built once per (w3, wd): the tensor-core
    body's ``(tc_table(w3), rnd(wd) | N)``, or the f32 body's one table
    ``f32_table(w3) | wd | N``.  A level's tables are
    fixed, and rebuilding them took longer on the host than a pass takes
    on the card.  Keyed by address and version; the entry holds w3 and wd,
    so no other tensor takes their address while it is cached."""
    key = (w3.data_ptr(), w3._version, wd.data_ptr(), wd._version, bf16)
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= 32:
            _TABLES.pop(next(iter(_TABLES)))
        N = _shape_vals(w3).reshape(-1)
        if bf16:
            tabs = (tc_table(w3), torch.cat([_bf16(wd).reshape(-1), N]))
        else:
            tabs = (torch.cat([f32_table(w3).reshape(-1), wd.reshape(-1),
                               N]),)
        hit = _TABLES[key] = (w3, wd, tabs)
    return hit[2]


def _otf_apply_3d_cuda(rho, maskf, w3, wd, b, x, *, niter, want_resid,
                       neg_resid, omega, p, mxu_bf16):
    nd = _check(rho, maskf, w3, wd, b, x, niter, want_resid)
    if rho.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {rho.dtype}")
    for t in (rho, maskf, w3, wd, b, x):
        if t is not None and not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    nz, ny, nx = rho.shape
    stream = _cuda.stream_ptr(rho)
    ptr = lambda t: None if t is None else t.data_ptr()
    if mxu_bf16:
        # the bf16-operand smoother pass on the tensor cores
        w3t, tab = _device_tables(w3, wd, True)

        def step(xin, out, om, mode):
            _cuda.launch("pyfem_otf_3d_tc", rho.data_ptr(), maskf.data_ptr(),
                         w3t.data_ptr(), tab.data_ptr(), ptr(b), ptr(xin),
                         out.data_ptr(), float(p), nd, nz, ny, nx, float(om),
                         mode, stream)
    else:
        (tables,) = _device_tables(w3, wd, False)

        def step(xin, out, om, mode):
            _cuda.launch("pyfem_otf_3d", rho.data_ptr(), maskf.data_ptr(),
                         tables.data_ptr(), ptr(b), ptr(xin), out.data_ptr(),
                         float(p), nd, nz, ny, nx, float(om), mode, stream)

    # ping-pong: a pass reads every neighbour of its input, so it never
    # writes in place; the caller's x is never written
    bufs = [torch.empty_like(maskf) for _ in range(min(niter, 2))]
    for i, om in enumerate(_omega_seq(omega, niter)):
        step(x, bufs[i % 2], om, _MODE_SWEEP)
        x = bufs[i % 2]
    r = None
    if want_resid:
        r = torch.empty_like(maskf)
        step(x, r, 0.0, _MODE_NEG_RESID if neg_resid else _MODE_RESID)
    return _outputs(x, r, niter, want_resid)


def otf_apply_3d(rho, maskf, w3, wd, b=None, x=None, *, niter=0,
                 want_resid=True, neg_resid=False, omega=0.6, p=0.0,
                 mxu_bf16=False):
    """OTF stencil apply / damped-Jacobi sweeps (K6).

    ``niter`` sweeps x <- x + omega_i * invd * (b - A x) from x (from
    x0 = 0 when ``x`` is None: the first sweep is then ``omega_0 * invd
    * b``), then optionally ``+-(b - A x)`` (``-A x`` when ``b`` is
    None).  ``niter=0``, ``x`` given, ``b=None``, ``neg_resid=True`` is
    the matvec ``A x``.  On the card each stencil pass is one launch of
    ``csrc/otf_3d.cu``: ``pyfem_otf_3d_tc`` (the product on the bf16
    tensor cores) when ``mxu_bf16``, else ``pyfem_otf_3d`` (float32 on
    the CUDA cores; on the tensor cores float32 would be TF32).

    Args:
        rho: (nz, ny, nx) nodal density.
        maskf: (nd, nz, ny, nx) free-dof mask (1.0 free / 0.0 fixed).
        w3, wd: :func:`otf_weights` tables in rho's dtype.
        b, x: (nd, nz, ny, nx) rhs / initial iterate, zero at fixed dofs.
        niter: sweeps (0: residual / matvec only).
        want_resid, neg_resid: emit (the negated) b - A x.
        omega: a damping factor or per-sweep factors (len >= niter).
        p: RAMP penalization.
        mxu_bf16: round the matmul operands to bf16 (smoother calls).

    Returns:
        x_out, r_out, or (x_out, r_out), per niter / want_resid.
    """
    kw = dict(niter=int(niter), want_resid=want_resid, neg_resid=neg_resid,
              omega=omega, p=p, mxu_bf16=mxu_bf16)
    if rho.device.type == "cuda":
        return _otf_apply_3d_cuda(rho, maskf, w3, wd, b, x, **kw)
    if rho.device.type == "cpu":
        return otf_apply_3d_plain(rho, maskf, w3, wd, b, x, **kw)
    raise ValueError(f"unsupported device {rho.device}")
