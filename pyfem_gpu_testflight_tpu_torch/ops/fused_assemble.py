"""K1, K3: uniform-geometry assembly of BC-eliminated stencil planes.

Port of ``pyfem_gpu_testflight_tpu/ops/pallas_assemble.py``
(``assembly_weights``, ``assemble_pack_2d`` — K1; ``assembly_weights3d``,
``assemble_pack_3d`` — K3, see the "3D" section).  One pass turns a nodal
density grid into the BC-eliminated stencil coefficient planes plus the
inverse diagonal consumed by ``fused_smooth`` — fusing material
interpolation, RAMP, the unit-matrix weighted sums and
``Stencil2D.bc_eliminate``.  On a uniform grid every element has the
same geometry, so

    coeff[k][iy, ix] = rowm * colm * sum_{ay, ax, q}
        W[k, ay ax, q] * Cq[q][iy - ay, ix - ax]  +  diag-fix

with ``Cq = RAMP(N @ rho_nodes)`` and ``W`` the unit matrices folded
through the stencil plan (:func:`assembly_weights`).

Layout is logical: ``rho (ny, nx)``, free mask ``(nd, ny, nx)`` (1.0
free / 0.0 fixed), outputs ``coeff (nk, ny, nx)`` — all ``nd*nd*9``
planes, or with ``sym=True`` the half-symmetric kept planes of
``fused_smooth.sym_planes_2d`` (19 at nd=2, 5 at nd=1) — and ``invd
(nd, ny, nx)``.  Inverse-diagonal convention: ``invd = rowm / diag``, i.e. 0
at fixed dofs (the JAX ``Level`` uses ``1 / diag``, 1 there; the two
agree on free dofs, and a V-cycle field is zero at fixed dofs either
way).  The TPU packing (halo rows, 128-lane padding) is not ported.

A CPU tensor takes the ``*_plain`` version; a CUDA tensor launches
``csrc/assemble_2d.cu`` (K1) or ``csrc/assemble_3d.cu`` (K3) or raises.
Both kernels read W compacted to its structurally nonzero weights
(:func:`k1_table`, :func:`k3_table`), built once per level and cached.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.base import ramp
from . import _cuda
from .fused_smooth import sym_planes_2d, sym_planes_3d
from .stencil import _HEX8_LOCAL, _QUAD4_LOCAL, Stencil3D

__all__ = [
    "assembly_weights",
    "assemble_pack_2d",
    "assemble_pack_2d_plain",
    "k1_table",
    "assembly_weights3d",
    "assemble_pack_3d",
    "assemble_pack_3d_plain",
    "k3_table",
    "shifted_materials_3d",
]


def assembly_weights(plan, Kq, nd, nq):
    """Host: fold unit matrices through the stencil plan.

    Returns W (nd*nd*9, 4, nq) float64: W[k, ay*2+ax, q] is the weight
    of Cq[q] at element offset (ay, ax) in plane k.
    """
    Kq = np.asarray(Kq, np.float64)
    W = np.zeros((nd * nd * 9, 4, nq))
    for (ca, cb, dy, dx, ay, ax, r, s) in plan:
        k = (ca * nd + cb) * 9 + dy * 3 + dx
        W[k, ay * 2 + ax, :] += Kq[:, r, s]
    return W


def _check(rho, maskf, W, N, nd):
    ny, nx = rho.shape
    nk = nd * nd * 9
    if nd not in (1, 2):
        raise ValueError(f"nd must be 1 or 2, got {nd}")
    if tuple(maskf.shape) != (nd, ny, nx):
        raise ValueError(f"maskf {tuple(maskf.shape)} != {(nd, ny, nx)}")
    if tuple(W.shape) != (nk, 4, 4) or tuple(N.shape) != (4, 4):
        raise ValueError(f"W {tuple(W.shape)} / N {tuple(N.shape)}: "
                         f"want ({nk}, 4, 4) / (4, 4)")
    for name, t in (("rho", rho), ("maskf", maskf), ("W", W), ("N", N)):
        if t.device != rho.device or t.dtype != rho.dtype:
            raise ValueError(f"{name} must be {rho.dtype} on {rho.device}")


def assemble_pack_2d_plain(rho, maskf, W, N, *, nd, p, lp_dtype=None,
                           sym=False):
    """Plain PyTorch K1 (any device, any float dtype).

    All planes, then the kept ones with ``sym=True``.  Returns (coeff,
    invd[, coeff_lp]) — see the module docstring.
    """
    _check(rho, maskf, W, N, nd)
    ny, nx = rho.shape
    nq = N.shape[0]
    rho_e = [rho[ay : ay + ny - 1, ax : ax + nx - 1]
             for ay, ax in _QUAD4_LOCAL]
    Cq = []
    for q in range(nq):
        acc = N[q, 0] * rho_e[0]
        for n in range(1, 4):
            acc = acc + N[q, n] * rho_e[n]
        Cq.append(ramp(acc, p))
    # element (ey, ex) at padded (ey+1, ex+1): phantom elements read 0
    Cq = F.pad(torch.stack(Cq), (1, 1, 1, 1))
    S = torch.stack([
        Cq[:, 1 - ay : 1 - ay + ny, 1 - ax : 1 - ax + nx]
        for ay in range(2) for ax in range(2)
    ])  # (4, nq, ny, nx), index ay*2+ax
    acc = (W.reshape(-1, 4 * nq) @ S.reshape(4 * nq, -1)).reshape(
        nd, nd, 3, 3, ny, nx
    )
    mp = F.pad(maskf, (1, 1, 1, 1))
    colm = torch.stack([
        torch.stack([mp[:, dy : dy + ny, dx : dx + nx] for dx in range(3)], 1)
        for dy in range(3)
    ], 1)  # (nd, 3, 3, ny, nx)
    coeff = acc * maskf[:, None, None, None] * colm[None]
    for c in range(nd):
        coeff[c, c, 1, 1] += 1.0 - maskf[c]
    diag = torch.stack([coeff[c, c, 1, 1] for c in range(nd)])
    invd = maskf / torch.where(diag == 0.0, 1.0, diag)
    coeff = coeff.reshape(nd * nd * 9, ny, nx)
    if sym:
        coeff = coeff[[k for (k, *_r) in sym_planes_2d(nd)]]
    if lp_dtype is None:
        return coeff, invd
    return coeff, invd, coeff.to(lp_dtype)


def _holds(offset, delta):
    """Element offset ``offset`` (per axis 0 or 1) holds both a node and
    its neighbour ``delta - 1`` (per axis): else the plan puts no weight
    there."""
    return all(0 <= a + d - 1 <= 1 for a, d in zip(offset, delta))


def _k1_rows(nd, sym):
    """Rows ``k_full * 4 + o`` of W (as (nd*nd*9*4, nq)) that K1 reads, in
    the order its plane loop consumes them: per (a, b) block of the 9
    (dy, dx) planes, element offset o = ay*2 + ax outermost, then each
    stored plane of the block (``sym_planes_2d``'s, or all) whose element
    o holds both the node and its neighbour (the other weights are zero
    by the stencil plan)."""
    stored = (set(k for (k, *_r) in sym_planes_2d(nd)) if sym
              else set(range(nd * nd * 9)))
    rows = []
    for blk in range(nd * nd):  # a * nd + b
        for o in range(4):
            for pl in range(9):
                k = blk * 9 + pl
                if k in stored and _holds((o >> 1, o & 1), divmod(pl, 3)):
                    rows.append(k * 4 + o)
    return rows


def k1_table(W, N, nd, sym):
    """The table ``csrc/assemble_2d.cu`` takes in its launch parameters
    (the constant bank): the structurally nonzero weights of W (nd*nd*9,
    4, nq) in consumption order (:func:`_k1_rows`, nq consecutive per
    row), then N (4, 4), flat in W's dtype: 64 weights per (a, b) block in
    full storage, 256 + 16 floats at nd=2."""
    rows = torch.as_tensor(_k1_rows(nd, sym), device=W.device)
    return torch.cat([W.reshape(-1, W.shape[-1])[rows].reshape(-1),
                      N.reshape(-1)])


_TABLES = {}


def _cached_table(make, W, N, nd, sym):
    """``make(W, N, nd, sym)``, built once per level and storage: keyed by
    W's and N's address and version; the entry holds W and N, so no other
    tensor takes their address while it is cached."""
    key = (make, W.data_ptr(), W._version, N.data_ptr(), N._version, nd,
           sym)
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= 64:
            _TABLES.pop(next(iter(_TABLES)))
        hit = _TABLES[key] = (W, N, make(W, N, nd, sym).contiguous())
    return hit[2]


def _k1_host_table(W, N, nd, sym):
    """:func:`k1_table` in host memory: the one device-to-host copy of a
    level, made at its first assembly."""
    return k1_table(W, N, nd, sym).cpu()


def _assemble_pack_2d_cuda(rho, maskf, W, N, *, nd, p, lp_dtype, sym):
    _check(rho, maskf, W, N, nd)
    if rho.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {rho.dtype}")
    if lp_dtype not in (None, torch.bfloat16):
        raise TypeError(f"lp_dtype must be None or bfloat16, got {lp_dtype}")
    for t in (rho, maskf, W, N):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    ny, nx = rho.shape
    tab = _cached_table(_k1_host_table, W, N, nd, sym)
    nk = len(sym_planes_2d(nd)) if sym else nd * nd * 9
    coeff = torch.empty((nk, ny, nx), dtype=rho.dtype, device=rho.device)
    invd = torch.empty((nd, ny, nx), dtype=rho.dtype, device=rho.device)
    lp = (None if lp_dtype is None else
          torch.empty((nk, ny, nx), dtype=lp_dtype, device=rho.device))
    _cuda.launch(
        "pyfem_assemble_2d_sym" if sym else "pyfem_assemble_2d",
        rho.data_ptr(), maskf.data_ptr(), tab.data_ptr(), tab.numel(),
        float(p), nd, ny, nx, coeff.data_ptr(), invd.data_ptr(),
        None if lp is None else lp.data_ptr(), _cuda.stream_ptr(rho),
    )
    return (coeff, invd) if lp is None else (coeff, invd, lp)


def assemble_pack_2d(rho, maskf, W, N, *, nd, p, lp_dtype=None, sym=False):
    """Density grid -> BC-eliminated coefficient planes + inverse diagonal.

    Args:
        rho: (ny, nx) nodal density.
        maskf: (nd, ny, nx) free-dof mask (1.0 free / 0.0 fixed).
        W: (nd*nd*9, 4, 4) :func:`assembly_weights` in rho's dtype.
        N: (4, 4) quad4 shape values at the quad points.
        nd, p: dofs per node and RAMP penalization.
        lp_dtype: also emit a low-precision copy of the planes (the
            smoother's) in the same pass.
        sym: half-symmetric storage (the kept planes of
            ``fused_smooth.sym_planes_2d``, the JAX ``pallas_sym``) or,
            with False, all nd*nd*9 planes.

    Returns:
        (coeff (nk, ny, nx), invd (nd, ny, nx)[, coeff_lp]), nk =
        nd*nd*9 or len(sym_planes_2d(nd)).
    """
    kw = dict(nd=nd, p=p, lp_dtype=lp_dtype, sym=bool(sym))
    if rho.device.type == "cuda":
        return _assemble_pack_2d_cuda(rho, maskf, W, N, **kw)
    if rho.device.type == "cpu":
        return assemble_pack_2d_plain(rho, maskf, W, N, **kw)
    raise ValueError(f"unsupported device {rho.device}")


# ---------------------------------------------------------------------------
# 3D (hex8, 27-point): K3
# ---------------------------------------------------------------------------
#
# Each kept plane k = (ca, cb, dz, dy, dx) of :func:`sym_planes_3d` at
# node (iz, iy, ix) is
#
#     coeff[k] = rowm * colm * sum_{o = (az, ay, ax), q}
#         W[k_full, o, q] * Cq[q][iz - az, iy - ay, ix - ax]  +  diag-fix
#
# over the 8 elements around the node, with Cq = RAMP(N @ rho_nodes) and
# phantom elements past the grid contributing 0.  Outputs are the
# planes ``coeff (nk, nz, ny, nx)`` that K4/K5 read — the half-symmetric
# storage (``sym=True``: 123 planes at nd=3, 14 at nd=1) or all
# ``nd*nd*27`` planes (``sym=False``: 243 / 27) — ``invd (nd, nz, ny,
# nx)`` (rowm / diag, 0 at fixed dofs) and optionally a bf16 copy of the
# planes.


def assembly_weights3d(plan, Kq, nd, nq):
    """Host: W (nd*nd*27, 8, nq) from the Stencil3D plan + unit matrices.

    W[k, az*4 + ay*2 + ax, q] is the weight of Cq[q] at element offset
    (az, ay, ax) in full plane k = (ca*nd + cb)*27 + dz*9 + dy*3 + dx.
    """
    Kq = np.asarray(Kq, np.float64)
    W = np.zeros((nd * nd * 27, 8, nq))
    for (ca, cb, dz, dy, dx, az, ay, ax, r, s) in plan:
        k = (ca * nd + cb) * 27 + dz * 9 + dy * 3 + dx
        W[k, az * 4 + ay * 2 + ax, :] += Kq[:, r, s]
    return W


def _check3d(rho, maskf, W, N, nd):
    nz, ny, nx = rho.shape
    if nd not in (1, 3):
        raise ValueError(f"nd must be 1 or 3, got {nd}")
    if tuple(maskf.shape) != (nd, nz, ny, nx):
        raise ValueError(f"maskf {tuple(maskf.shape)} != {(nd, nz, ny, nx)}")
    if tuple(W.shape) != (nd * nd * 27, 8, 8) or tuple(N.shape) != (8, 8):
        raise ValueError(f"W {tuple(W.shape)} / N {tuple(N.shape)}: want "
                         f"({nd * nd * 27}, 8, 8) / (8, 8)")
    for name, t in (("rho", rho), ("maskf", maskf), ("W", W), ("N", N)):
        if t.device != rho.device or t.dtype != rho.dtype:
            raise ValueError(f"{name} must be {rho.dtype} on {rho.device}")


def shifted_materials_3d(rho, N, p):
    """RAMP material of the 8 elements around every node.

    Returns S (8, nq, nz, ny, nx): S[o, q][i] = RAMP(N[q] . rho)[element
    i - o] with o = az*4 + ay*2 + ax, 0 for phantom elements past the
    grid.  K3 contracts it with W, K6 with the OTF tables.
    """
    nz, ny, nx = rho.shape
    rho_e = [rho[az : az + nz - 1, ay : ay + ny - 1, ax : ax + nx - 1]
             for az, ay, ax in _HEX8_LOCAL]
    Cq = []
    for q in range(N.shape[0]):
        acc = N[q, 0] * rho_e[0]
        for n in range(1, 8):
            acc = acc + N[q, n] * rho_e[n]
        Cq.append(ramp(acc, p))
    # element (ez, ey, ex) at padded (ez+1, ey+1, ex+1): phantoms read 0
    Cq = F.pad(torch.stack(Cq), (1, 1, 1, 1, 1, 1))
    return torch.stack([
        Cq[:, 1 - az : 1 - az + nz, 1 - ay : 1 - ay + ny, 1 - ax : 1 - ax + nx]
        for az in range(2) for ay in range(2) for ax in range(2)
    ])


def assemble_pack_3d_plain(rho, maskf, W, N, *, nd, p, lp_dtype=None,
                           sym=True):
    """Plain PyTorch K3 (any device, any float dtype).

    All 243 (nd=3) planes as one weights-by-shifted-material product,
    Dirichlet elimination by ``Stencil3D.bc_eliminate``, then the kept
    planes (``sym=True``) or all of them.  Returns (coeff, invd[,
    coeff_lp]).
    """
    _check3d(rho, maskf, W, N, nd)
    nz, ny, nx = rho.shape
    S = shifted_materials_3d(rho, N, p)
    full = (W.reshape(-1, S.shape[0] * S.shape[1]) @ S.reshape(
        S.shape[0] * S.shape[1], -1)).reshape(nd, nd, 3, 3, 3, nz, ny, nx)
    op = Stencil3D(nx, ny, nz, nd)
    ce = op.bc_eliminate(full, maskf == 0)
    diag = op.diagonal(ce)
    invd = maskf / torch.where(diag == 0.0, 1.0, diag)
    coeff = ce.reshape(nd * nd * 27, nz, ny, nx)
    if sym:
        coeff = coeff[[k for (k, *_r) in sym_planes_3d(nd)]]
    if lp_dtype is None:
        return coeff, invd
    return coeff, invd, coeff.to(lp_dtype)


def _k3_rows(nd, sym):
    """Rows ``k_full * 8 + o`` of W (as (nd*nd*27*8, nq)) that K3 reads,
    in the order its plane loop consumes them: per (a, b, dz)
    block of the 9 (dy, dx) planes, element offset o outermost, then each
    stored plane of the block (``sym_planes_3d``'s, or all) whose element
    o holds both the node and its neighbour (the other weights are zero
    by the stencil plan)."""
    stored = (set(k for (k, *_r) in sym_planes_3d(nd)) if sym
              else set(range(nd * nd * 27)))
    rows = []
    for blk in range(nd * nd * 3):  # (a * nd + b) * 3 + dz
        dz = blk % 3
        for o in range(8):
            az, ay, ax = o >> 2, (o >> 1) & 1, o & 1
            for pl in range(9):
                k = blk * 9 + pl
                dy, dx = divmod(pl, 3)
                if k in stored and _holds((az, ay, ax), (dz, dy, dx)):
                    rows.append(k * 8 + o)
    return rows


def k3_table(W, N, nd, sym):
    """The table ``csrc/assemble_3d.cu`` stages in shared memory: the
    structurally nonzero weights of W (nd*nd*27, 8, nq) in consumption
    order (:func:`_k3_rows`, nq consecutive per row), then N (8, 8), flat
    in W's dtype: 512 weights per (a, b) block in full storage."""
    rows = torch.as_tensor(_k3_rows(nd, sym), device=W.device)
    return torch.cat([W.reshape(-1, W.shape[-1])[rows].reshape(-1),
                      N.reshape(-1)])


def _assemble_pack_3d_cuda(rho, maskf, W, N, *, nd, p, lp_dtype, sym):
    _check3d(rho, maskf, W, N, nd)
    if rho.dtype != torch.float32:
        raise TypeError(f"the CUDA kernel takes float32, got {rho.dtype}")
    if lp_dtype not in (None, torch.bfloat16):
        raise TypeError(f"lp_dtype must be None or bfloat16, got {lp_dtype}")
    for t in (rho, maskf, W, N):
        if not t.is_contiguous():
            raise ValueError("inputs must be contiguous")
    nz, ny, nx = rho.shape
    tab = _cached_table(k3_table, W, N, nd, sym)
    nk = len(sym_planes_3d(nd)) if sym else nd * nd * 27
    coeff = torch.empty((nk, nz, ny, nx), dtype=rho.dtype, device=rho.device)
    invd = torch.empty((nd, nz, ny, nx), dtype=rho.dtype, device=rho.device)
    lp = (None if lp_dtype is None else
          torch.empty((nk, nz, ny, nx), dtype=lp_dtype, device=rho.device))
    _cuda.launch(
        "pyfem_assemble_3d", rho.data_ptr(), maskf.data_ptr(),
        tab.data_ptr(), tab.numel(), float(p), nd, nz, ny, nx,
        int(not sym), coeff.data_ptr(), invd.data_ptr(),
        None if lp is None else lp.data_ptr(), _cuda.stream_ptr(rho),
    )
    return (coeff, invd) if lp is None else (coeff, invd, lp)


def assemble_pack_3d(rho, maskf, W, N, *, nd, p, lp_dtype=None, sym=True):
    """3D density grid -> BC-eliminated planes + inverse diagonal (K3).

    Args:
        rho: (nz, ny, nx) nodal density.
        maskf: (nd, nz, ny, nx) free-dof mask (1.0 free / 0.0 fixed).
        W: (nd*nd*27, 8, 8) :func:`assembly_weights3d` in rho's dtype.
        N: (8, 8) hex8 shape values at the quad points.
        nd, p: dofs per node (3 or 1) and RAMP penalization.
        lp_dtype: also emit a low-precision copy of the planes (the
            smoother's) in the same pass.
        sym: half-symmetric storage (the kept planes of
            ``sym_planes_3d``) or, with False, all nd*nd*27 planes.

    Returns:
        (coeff (nk, nz, ny, nx), invd (nd, nz, ny, nx)[, coeff_lp]),
        nk = len(sym_planes_3d(nd)) or nd*nd*27.
    """
    kw = dict(nd=nd, p=p, lp_dtype=lp_dtype, sym=bool(sym))
    if rho.device.type == "cuda":
        return _assemble_pack_3d_cuda(rho, maskf, W, N, **kw)
    if rho.device.type == "cpu":
        return assemble_pack_3d_plain(rho, maskf, W, N, **kw)
    raise ValueError(f"unsupported device {rho.device}")
