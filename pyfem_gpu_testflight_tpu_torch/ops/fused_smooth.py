"""K2, K4, K5: damped-Jacobi sweeps (+ residual) on stencil planes.

Port of ``fused_sweeps_2d`` / ``_omega_seq`` (K2) and the 3D
``fused_sweep_3d`` (K4) / ``fused_sweeps3d`` (K5) from
``pyfem_gpu_testflight_tpu/ops/pallas_smooth.py``; the 3D pair is
described in the "3D" section below.  K2 runs

    x <- x + omega_i * invD * (b - A x)

``niter`` times, then optionally returns ``±(b - A x)``; ``niter=0``
with ``neg_resid=True`` and ``b=None`` is the operator matvec.  The
coefficients are the BC-eliminated planes of ``fused_assemble`` (so the
matvec is select-free) in the logical layout ``(nk, ny, nx)`` — all
``nk = nd*nd*9`` planes, or the half-symmetric kept planes of
:func:`sym_planes_2d` (the TPU kernel's ``sym_list`` storage), told
apart by the plane count — as
float32 or bfloat16 (loaded as bf16, arithmetic in the field dtype);
fields are ``(nd, ny, nx)`` and zero at fixed dofs (the V-cycle
invariant).  A first sweep from ``x = None`` (x0 = 0) is elementwise
and consumes ``omega[0]``.

On the card a full-storage call with ``niter >= 1`` is one launch of
``csrc/smooth_2d.cu``'s ``pyfem_sweeps_2d``, as the TPU kernel's is: each
tile is computed from the tile plus a ghost ring as wide as the call's
stencil steps, its coefficients read once for all sweeps and the
residual.
The launch budget is :data:`SWEEP_BUDGET_2D` stencil steps (the TPU
kernel's was 7 ghost rows); a call with more runs in groups of sweeps,
one launch each (:func:`sweep_plan_2d`), so any ``niter >= 0`` is
accepted.  The ``niter=0`` matvec and residual are one stencil step,
one launch of ``pyfem_smooth_2d``; half storage still launches that
step kernel once per sweep.

A CPU tensor takes the ``*_plain`` version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from . import _cuda
from .stencil import Stencil2D, Stencil3D

__all__ = [
    "sym_planes_2d",
    "full_planes_2d",
    "as_full_planes_2d",
    "is_full_storage_2d",
    "SWEEP_BUDGET_2D",
    "sweep_plan_2d",
    "fused_sweeps_2d",
    "fused_sweeps_2d_plain",
    "sym_planes_3d",
    "halo_sweeps_3d",
    "full_planes_3d",
    "as_full_planes_3d",
    "is_full_storage_3d",
    "fused_sweep_3d",
    "fused_sweep_3d_plain",
    "fused_sweeps3d",
    "fused_sweeps3d_plain",
]

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


@functools.lru_cache(maxsize=None)
def sym_planes_2d(nd):
    """Kept-plane list for half-symmetric 2D (9-point) storage.

    The BC-eliminated operator is symmetric, so plane (a, b, dy, dx) and
    its partner (b, a, 2-dy, 2-dx) hold the same values one node apart:
    ``coeff[(b,a,2-dy,2-dx)][i] = coeff[(a,b,dy,dx)][i+d-1]``.  One plane
    per pair is kept, the one first in the full order: 19 of 36 planes
    for nd=2, 5 of 9 for nd=1.

    Returns (k_full, ca, cb, dy, dx, is_self) in storage order.
    """
    out = []
    for a in range(nd):
        for b in range(nd):
            for dy in range(3):
                for dx in range(3):
                    k = (a * nd + b) * 9 + dy * 3 + dx
                    pk = (b * nd + a) * 9 + (2 - dy) * 3 + (2 - dx)
                    if pk < k:
                        continue
                    out.append((k, a, b, dy, dx, pk == k))
    return tuple(out)


def full_planes_2d(coeff, nd):
    """Kept planes (nk, ny, nx) -> full (nd, nd, 3, 3, ny, nx).

    The partner of kept plane (a, b, d) is (b, a, 2 - d), holding at
    node j the kept value of node j - (d - 1) (0 past the grid).
    """
    ny, nx = coeff.shape[1:]
    full = coeff.new_zeros((nd, nd, 3, 3, ny, nx))
    cp = F.pad(coeff, (1, 1, 1, 1))
    for si, (_k, a, b, dy, dx, selfp) in enumerate(sym_planes_2d(nd)):
        full[a, b, dy, dx] = coeff[si]
        if not selfp:
            full[b, a, 2 - dy, 2 - dx] = cp[si, 2 - dy : 2 - dy + ny,
                                            2 - dx : 2 - dx + nx]
    return full


def is_full_storage_2d(coeff, nd):
    """True for all nd*nd*9 planes, False for the kept planes."""
    return coeff.shape[0] == nd * nd * 9


def as_full_planes_2d(coeff, nd):
    """Either storage -> full planes (nd, nd, 3, 3, ny, nx)."""
    if is_full_storage_2d(coeff, nd):
        return coeff.reshape((nd, nd, 3, 3) + tuple(coeff.shape[1:]))
    return full_planes_2d(coeff, nd)


def _check(coeff, invd, b, x, niter, want_resid):
    if x is None and b is None:
        raise ValueError("b and x cannot both be zero (None)")
    if x is None and niter == 0:
        raise ValueError("niter=0 needs an iterate x")
    if niter == 0 and not want_resid:
        raise ValueError("niter=0 without want_resid computes nothing")
    nd, ny, nx = invd.shape
    nks = (nd * nd * 9, len(sym_planes_2d(nd)))
    if coeff.shape[0] not in nks or tuple(coeff.shape[1:]) != (ny, nx):
        raise ValueError(f"coeff {tuple(coeff.shape)}: want full or sym "
                         f"storage, ({nks[0]} or {nks[1]}, {ny}, {nx})")
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
    c = as_full_planes_2d(coeff.to(invd.dtype), nd)
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


# stencil steps one launch of pyfem_sweeps_2d takes (csrc/smooth_2d.cu
# kMaxSteps): the ghost ring costs 2 (g - 1) of the region's 32 columns
SWEEP_BUDGET_2D = 4
# rows of the region (32 columns) a block of pyfem_sweeps_2d computes, by
# nd: csrc/smooth_2d.cu Region<ND, CT>::rows
_SWEEP_ROWS_2D = {1: 32, 2: 16}


def sweep_plan_2d(nd, ny, nx, niter, x0_zero, want_resid):
    """The launches of one full-storage call on the card.

    The call's stencil steps (its sweeps, less the elementwise first
    sweep from x0 = 0, plus the residual) are split into as few groups
    of at most :data:`SWEEP_BUDGET_2D` as will do, as even as possible,
    the residual last.  A group's ghost width ``g`` is its stencil steps
    (at least 1); each tile of ``tile`` = (rows, columns) nodes, its
    region less a ring of ``g - 1``, is computed from its planes on the
    region and the iterate on the tile plus a ring of ``g``.

    Every group holds a sweep when ``niter >= 1``; at ``niter = 0`` the
    plan is the residual alone (g = 1), which the card runs by the step
    kernel.

    Returns a list of dicts, one per launch: ``sweeps`` (range of sweep
    indices of the call), ``first_elem``, ``resid``, ``g``, ``tile``
    and ``grid`` (tiles along y, x).
    """
    first = 1 if (x0_zero and niter > 0) else 0
    stencil = niter - first
    steps = stencil + (1 if want_resid else 0)
    ngroups = max(1, math.ceil(steps / SWEEP_BUDGET_2D))
    qh, qw = _SWEEP_ROWS_2D[nd], 32
    plan, s0 = [], 0
    for j in range(ngroups):
        n = steps // ngroups + (1 if j < steps % ngroups else 0)
        resid = want_resid and j == ngroups - 1
        nst = n - (1 if resid else 0)
        lo = first + s0 - (first if j == 0 else 0)
        sweeps = range(lo, first + s0 + nst)
        g = max(n, 1)
        tile = (qh - 2 * (g - 1), qw - 2 * (g - 1))
        plan.append(dict(sweeps=sweeps, first_elem=first if j == 0 else 0,
                         resid=resid, g=g, tile=tile,
                         grid=(-(-ny // tile[0]), -(-nx // tile[1]))))
        s0 += nst
    return plan


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
    ptr = lambda t: None if t is None else t.data_ptr()
    nd, ny, nx = invd.shape
    bf16 = int(coeff.dtype == torch.bfloat16)
    stream = _cuda.stream_ptr(invd)
    rmode = _MODE_NEG_RESID if neg_resid else _MODE_RESID
    full = is_full_storage_2d(coeff, nd)
    if full and niter > 0:
        # the kernel stages 16-byte chunks: a view that starts elsewhere
        # (a slice) is copied
        coeff, invd, b, x = (t if t is None or t.data_ptr() % 16 == 0
                             else t.clone() for t in (coeff, invd, b, x))
        oms = _omega_seq(omega, niter)
        r = None
        for grp in sweep_plan_2d(nd, ny, nx, niter, x is None, want_resid):
            n = len(grp["sweeps"])
            xo = torch.empty_like(invd)
            if grp["resid"]:
                r = torch.empty_like(invd)
            w = [oms[i] for i in grp["sweeps"]]
            _cuda.launch("pyfem_sweeps_2d", coeff.data_ptr(), bf16,
                         invd.data_ptr(), ptr(b), ptr(x), xo.data_ptr(),
                         ptr(r if grp["resid"] else None),
                         (ctypes.c_float * n)(*w), n, grp["first_elem"],
                         rmode if grp["resid"] else -1, grp["g"],
                         *grp["tile"], nd, ny, nx, stream)
            x = xo
        return _outputs(x, r, niter, want_resid)
    entry = "pyfem_smooth_2d" if full else "pyfem_smooth_2d_sym"

    def step(xin, out, om, mode):
        _cuda.launch(entry, coeff.data_ptr(), bf16,
                     invd.data_ptr(), ptr(b), ptr(xin), out.data_ptr(),
                     nd, ny, nx, float(om), mode, stream)

    # half storage, one launch a sweep into two ping-pong buffers (a sweep
    # reads every neighbour of its input, so it can never write in place;
    # the caller's x is never written); full storage at niter = 0
    bufs = [torch.empty_like(invd) for _ in range(min(niter, 2))]
    for i, om in enumerate(_omega_seq(omega, niter)):
        out = bufs[i % 2]
        step(x, out, om, _MODE_SWEEP)
        x = out
    r = None
    if want_resid:
        r = torch.empty_like(invd)
        step(x, r, 0.0, rmode)
    return _outputs(x, r, niter, want_resid)


def fused_sweeps_2d(coeff, invd, b=None, x=None, *, niter=2,
                    want_resid=False, neg_resid=False, omega=0.7):
    """Damped-Jacobi sweeps (+ optional residual) on stencil planes.

    Args:
        coeff: (nk, ny, nx) BC-eliminated planes, f32 or bf16: all
            nd*nd*9, or the kept planes of :func:`sym_planes_2d`.
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


# ---------------------------------------------------------------------------
# 3D: K4 (one 27-point operation) and K5 (all sweeps of a smoothing call)
# ---------------------------------------------------------------------------
#
# The 3D coefficients are the BC-eliminated 27-point stencil written by
# K3 (ops.fused_assemble) in the logical layout (nk, nz, ny, nx), f32 or
# bf16, in one of two storages told apart by the plane count: full (all
# nk = nd*nd*27 planes, k = (a*nd + b)*27 + dz*9 + dy*3 + dx, the TPU
# kernel's ``_kernel3d``) or half-symmetric ("sym", ``_kernel3d_sym``,
# the kept planes of :func:`sym_planes_3d`).  Fields are (nd, nz, ny,
# nx).  A kept
# plane k = (a, b, dz, dy, dx) at node i adds coeff[k][i] *
# x[b][i + d - 1] to y[a][i]; unless it is its own partner, its partner
# (b, a, 2 - dz, 2 - dy, 2 - dx) adds, at node j, the stored
# coefficient of node j - (d - 1) times x[a][j - (d - 1)].  Off-grid
# neighbours read as 0.  The TPU z-tiling, halo planes, ``_nyp8`` rows
# and ``SWEEP3_ZEXT`` trailing planes are not ported.


@functools.lru_cache(maxsize=None)
def sym_planes_3d(nd):
    """Kept-plane list for symmetric 3D (27-point) storage.

    Keeps all dz=0 planes (their dz=2 partners are rebuilt from the
    next z-plane), drops all dz=2, and keeps the 2D-rule half of dz=1:
    123 of 243 planes for nd=3, 14 of 27 for nd=1.

    Returns (k_full, ca, cb, dz, dy, dx, is_self) in storage order.
    """
    out = []
    for a in range(nd):
        for b in range(nd):
            for dz in range(3):
                for dy in range(3):
                    for dx in range(3):
                        if dz == 2:
                            continue
                        selfp = False
                        if dz == 1:
                            k2 = (a * nd + b) * 9 + dy * 3 + dx
                            p2 = (b * nd + a) * 9 + (2 - dy) * 3 + (2 - dx)
                            if p2 < k2:
                                continue
                            selfp = p2 == k2
                        k = (a * nd + b) * 27 + dz * 9 + dy * 3 + dx
                        out.append((k, a, b, dz, dy, dx, selfp))
    return tuple(out)


def halo_sweeps_3d(niter, x0_zero, want_resid):
    """Stencil passes of one fused_sweeps3d call.

    The first sweep from x0 = 0 is elementwise and reads no
    coefficients; every other sweep and the trailing residual reads them
    once.  K5's per-sweep form launches this many stencil passes (the
    TPU kernel spent the same count as z ghost planes).
    """
    return (niter - (1 if x0_zero else 0)) + (1 if want_resid else 0)


def full_planes_3d(coeff, nd):
    """Sym planes (nk, nz, ny, nx) -> full (nd, nd, 3, 3, 3, nz, ny, nx).

    The partner of kept plane (a, b, d) is (b, a, 2 - d), holding at
    node j the kept value of node j - (d - 1) (0 past the grid).
    """
    nz, ny, nx = coeff.shape[1:]
    full = coeff.new_zeros((nd, nd, 3, 3, 3, nz, ny, nx))
    cp = F.pad(coeff, (1, 1, 1, 1, 1, 1))
    for si, (_k, a, b, dz, dy, dx, selfp) in enumerate(sym_planes_3d(nd)):
        full[a, b, dz, dy, dx] = coeff[si]
        if not selfp:
            full[b, a, 2 - dz, 2 - dy, 2 - dx] = cp[
                si, 2 - dz : 2 - dz + nz, 2 - dy : 2 - dy + ny,
                2 - dx : 2 - dx + nx
            ]
    return full


def is_full_storage_3d(coeff, nd):
    """True for all nd*nd*27 planes, False for the sym kept planes."""
    return coeff.shape[0] == nd * nd * 27


def as_full_planes_3d(coeff, nd):
    """Either storage -> full planes (nd, nd, 3, 3, 3, nz, ny, nx)."""
    if is_full_storage_3d(coeff, nd):
        return coeff.reshape((nd, nd, 3, 3, 3) + tuple(coeff.shape[1:]))
    return full_planes_3d(coeff, nd)


def _check3d(coeff, invd, b, x):
    ref = invd if invd is not None else (b if b is not None else x)
    if ref is None or ref.dim() != 4:
        raise ValueError("need (nd, nz, ny, nx) fields")
    nd, nz, ny, nx = ref.shape
    if nd not in (1, 3):
        raise ValueError(f"nd must be 1 or 3, got {nd}")
    nks = (len(sym_planes_3d(nd)), nd * nd * 27)
    if coeff.shape[0] not in nks or tuple(coeff.shape[1:]) != (nz, ny, nx):
        raise ValueError(f"coeff {tuple(coeff.shape)}: want sym or full "
                         f"storage, ({nks[0]} or {nks[1]}, {nz}, {ny}, {nx})")
    for name, t in (("invd", invd), ("b", b), ("x", x)):
        if t is not None and (t.shape != ref.shape or t.dtype != ref.dtype
                              or t.device != ref.device):
            raise ValueError(f"{name} must match the fields' shape/dtype/"
                             f"device")
    if coeff.device != ref.device:
        raise ValueError("coeff and fields on different devices")
    return nd, nz, ny, nx


def _sweep3d_args(mode, invd, b, x):
    if mode not in ("sweep", "resid", "matvec"):
        raise ValueError(f"mode must be sweep, resid or matvec, got {mode!r}")
    if x is None:
        raise ValueError("fused_sweep_3d needs an iterate x")
    if mode == "sweep" and (invd is None or b is None):
        raise ValueError("mode='sweep' needs invd and b")
    if mode == "resid" and b is None:
        raise ValueError("mode='resid' needs b")


def fused_sweep_3d_plain(coeff, invd=None, b=None, x=None, *, mode="sweep",
                         neg_resid=False, omega=0.6):
    """Plain PyTorch K4 (any device); same contract as fused_sweep_3d."""
    _sweep3d_args(mode, invd, b, x)
    nd, nz, ny, nx = _check3d(coeff, invd, b, x)
    ax = Stencil3D(nx, ny, nz, nd).matvec(
        as_full_planes_3d(coeff.to(x.dtype), nd), x
    )
    if mode == "matvec":
        return ax if neg_resid else -ax
    if mode == "resid":
        return (ax - b) if neg_resid else (b - ax)
    return x + omega * invd * (b - ax)


def _sweep3d_ptrs(coeff, invd, b, x):
    for t in (invd, b, x):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32 fields, got "
                            f"{t.dtype}")
    if coeff.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"coefficients must be float32 or bfloat16, got "
                        f"{coeff.dtype}")
    for t in (coeff, invd, b, x):
        if t is not None and not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    return lambda t: None if t is None else t.data_ptr()


# dynamic shared memory one block of csrc/smooth_3d.cu may use (227 KiB)
_SMEM_MAX = 227 * 1024


def sweep3d_smem(nd, nx):
    """Bytes of the x window a block of ``sweep_3d_kernel`` stages in
    shared memory (csrc/smooth_3d.cu ``launch_body``): 3 planes of nd
    components, each a padded window of ~2 nx + 137 floats."""
    wl = 128 + 2 * ((128 + nx - 2) // nx) + 2 * (nx + 2) + 3
    return 4 * 3 * nd * ((wl + 3) // 4 * 4)


def _check_window(nd, nx):
    if sweep3d_smem(nd, nx) > _SMEM_MAX:
        raise ValueError(
            f"nx={nx} is too wide for the 3D stencil pass on the card: its "
            f"x window takes {sweep3d_smem(nd, nx)} B of shared memory, a "
            f"block may use {_SMEM_MAX} (nx <= 3159 at nd=3, 9615 at nd=1)")


def _fused_sweep_3d_cuda(coeff, invd, b, x, *, mode, neg_resid, omega):
    _sweep3d_args(mode, invd, b, x)
    nd, nz, ny, nx = _check3d(coeff, invd, b, x)
    _check_window(nd, nx)
    ptr = _sweep3d_ptrs(coeff, invd, b, x)
    cmode = (_MODE_SWEEP if mode == "sweep" else
             _MODE_NEG_RESID if neg_resid else _MODE_RESID)
    out = torch.empty_like(x)
    # matvec is the residual with b = 0: -A x, or A x with neg_resid
    _cuda.launch("pyfem_sweep_3d", coeff.data_ptr(),
                 int(coeff.dtype == torch.bfloat16),
                 int(is_full_storage_3d(coeff, nd)), ptr(invd),
                 ptr(None if mode == "matvec" else b), x.data_ptr(),
                 out.data_ptr(), nd, nz, ny, nx, float(omega), cmode,
                 _cuda.stream_ptr(x))
    return out


def fused_sweep_3d(coeff, invd=None, b=None, x=None, *, mode="sweep",
                   neg_resid=False, omega=0.6):
    """One 27-point operation on 3D stencil planes (K4).

    mode: "sweep"  -> x + omega * invd * (b - A x)   (needs invd, b, x)
          "resid"  -> +-(b - A x)                    (needs b, x)
          "matvec" -> A x (neg_resid=True) or -A x   (needs x only)

    Args:
        coeff: (nk, nz, ny, nx) kept planes (:func:`sym_planes_3d`) or
            all nd*nd*27 planes, f32 or bf16 (loaded as bf16, arithmetic
            in f32).
        invd, b, x: (nd, nz, ny, nx) fields.
    """
    kw = dict(mode=mode, neg_resid=neg_resid, omega=omega)
    dev = x.device if x is not None else coeff.device
    if dev.type == "cuda":
        return _fused_sweep_3d_cuda(coeff, invd, b, x, **kw)
    if dev.type == "cpu":
        return fused_sweep_3d_plain(coeff, invd, b, x, **kw)
    raise ValueError(f"unsupported device {dev}")


def _sweeps3d_args(b, niter):
    if b is None:
        raise ValueError("fused_sweeps3d needs b")
    if niter < 1:
        raise ValueError(f"fused_sweeps3d needs niter >= 1, got {niter}")


def fused_sweeps3d_plain(coeff, invd, b, x=None, *, niter=2,
                         want_resid=False, neg_resid=False, omega=0.6):
    """Plain PyTorch K5 (any device); same contract as fused_sweeps3d."""
    _sweeps3d_args(b, niter)
    nd, nz, ny, nx = _check3d(coeff, invd, b, x)
    op = Stencil3D(nx, ny, nz, nd)
    c = as_full_planes_3d(coeff.to(invd.dtype), nd)
    for om in _omega_seq(omega, niter):
        if x is None:  # first sweep from x0 = 0: elementwise
            x = om * invd * b
        else:
            x = x + om * invd * (b - op.matvec(c, x))
    if not want_resid:
        return x
    r = b - op.matvec(c, x)
    return x, (-r if neg_resid else r)


def _fused_sweeps3d_cuda(coeff, invd, b, x, *, niter, want_resid,
                         neg_resid, omega):
    _sweeps3d_args(b, niter)
    nd, nz, ny, nx = _check3d(coeff, invd, b, x)
    _check_window(nd, nx)
    ptr = _sweep3d_ptrs(coeff, invd, b, x)
    oms = _omega_seq(omega, niter)
    # ping-pong buffers: a sweep reads every neighbour of its input, so
    # it can never write in place; the caller's x is never written
    bufs = [torch.empty_like(b) for _ in range(min(niter, 2))]
    r = torch.empty_like(b) if want_resid else None
    rmode = (-1 if not want_resid else
             _MODE_NEG_RESID if neg_resid else _MODE_RESID)
    _cuda.launch("pyfem_sweeps_3d", coeff.data_ptr(),
                 int(coeff.dtype == torch.bfloat16),
                 int(is_full_storage_3d(coeff, nd)), invd.data_ptr(),
                 b.data_ptr(), ptr(x), bufs[0].data_ptr(),
                 bufs[-1].data_ptr(), ptr(r), (ctypes.c_float * niter)(*oms),
                 niter, rmode, nd, nz, ny, nx, _cuda.stream_ptr(b))
    xo = bufs[(niter - 1) % 2]
    return (xo, r) if want_resid else xo


def fused_sweeps3d(coeff, invd, b, x=None, *, niter=2, want_resid=False,
                   neg_resid=False, omega=0.6):
    """All damped-Jacobi sweeps of one 3D smoothing call (+ residual), K5.

    ``niter`` sweeps x <- x + omega_i * invd * (b - A x) from x (or from
    x0 = 0 when ``x`` is None: the first sweep is then ``omega_0 * invd
    * b``), then optionally ``+-(b - A x)``.  On the card this is one
    call of ``csrc/smooth_3d.cu``'s ``pyfem_sweeps_3d``, which launches
    one stencil pass per sweep and one for the residual
    (:func:`halo_sweeps_3d` passes plus the elementwise first sweep), so
    any ``niter >= 1`` is accepted; the single-pass z-blocked form is
    ROADMAP work.

    Args:
        coeff: (nk, nz, ny, nx) sym or full planes, f32 or bf16.
        invd, b: (nd, nz, ny, nx) inverse diagonal (0 at fixed dofs) and
            right-hand side (0 at fixed dofs).
        x: (nd, nz, ny, nx) initial iterate, or None for x0 = 0.
        niter: sweeps (>= 1).
        want_resid: also return sign*(b - A x_final).
        neg_resid: flip the residual sign (A x - b).
        omega: a damping factor, or per-sweep factors (len >= niter).

    Returns:
        x_out, or (x_out, r_out) with want_resid.
    """
    kw = dict(niter=int(niter), want_resid=want_resid,
              neg_resid=neg_resid, omega=omega)
    if coeff.device.type == "cuda":
        return _fused_sweeps3d_cuda(coeff, invd, b, x, **kw)
    if coeff.device.type == "cpu":
        return fused_sweeps3d_plain(coeff, invd, b, x, **kw)
    raise ValueError(f"unsupported device {coeff.device}")
