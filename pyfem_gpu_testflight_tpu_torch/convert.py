"""Carry the reference package's GMG state into the port.

For this FEM system the "weights" are the problem data (``X``,
``conn``, ``dof_fixed``, ``nodal_force`` — plain numpy, passed to both
packages' constructors as they are), the nodal density, and the static
per-level tables a ``GMGAssembler`` / ``GMGAssembler3D`` computes at
setup: the unit element matrices ``Kq``, the K1 / K3 weights ``W``, the
Dirichlet masks, on the 3D on-the-fly route the K6 tables ``(w3, wd)``,
and the 3D coefficient storage flag.

:func:`assembler_state_from_numpy` installs those tables, taken as
numpy from a JAX ``GMGAssembler`` or ``GMGAssembler3D``
(``np.asarray(asm.static_levels[l][5])`` for ``Kq``, ``[3]`` for the
mask, ``[7]`` for the OTF tables, ``asm.pallas_sym`` for the storage),
into a port assembler of the same grid, so both packages can run from
identical tables.  The port's
own setup reproduces them (tests/test_torch_tables.py), so this is a
test aid, not a dependency.

On the general-mesh element path the state is the mesh, the density and
the element tables, passed to both packages as they are.  What differs
is the element kernels' layout: :func:`ket_to_ke` takes the JAX Pallas
kernels' element-minor ``KeT (ndpe*ndpe, nelems)`` to the element-major
``Ke (nelems, ndpe, ndpe)`` through the port's one transpose pair
(``ops.element_kernels.transpose_xe`` / ``untranspose``, which also
takes ``Xe (nelems, nn, ndims)`` to ``XeT (nn*ndims, nelems)``).  It
takes a numpy array or a torch tensor and returns the same kind.

Topology optimization's state is the optimizer's:
:func:`load_topo_checkpoint` reads a ``DeviceTopo`` checkpoint npz of
either package (the keys are the same; ``u_prev`` is planar ``(nd, ny,
nx)`` in 2D and ``(nd, nz, ny, nx)`` in 3D in both) into the port's
device tensors, so the port can resume a JAX run.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.element_kernels import untranspose
from .ops.fused_assemble import assembly_weights, assembly_weights3d

__all__ = ["assembler_state_from_numpy", "ket_to_ke",
           "load_topo_checkpoint"]


def _same_kind(fn, a, *args):
    """``fn`` on a torch tensor, or on a numpy array (returned as one)."""
    if torch.is_tensor(a):
        return fn(a, *args)
    return fn(torch.as_tensor(np.array(a)), *args).numpy()


def ket_to_ke(KeT):
    """(ndpe*ndpe, nelems) -> (nelems, ndpe, ndpe)."""
    ndpe = int(round(KeT.shape[0] ** 0.5))
    if ndpe * ndpe != KeT.shape[0]:
        raise ValueError(f"KeT has {KeT.shape[0]} rows, not a square")
    return _same_kind(untranspose, KeT, ndpe, ndpe)


def load_topo_checkpoint(path, dtype, device):
    """A ``DeviceTopo`` checkpoint (either package's npz) as the port's
    optimizer state.

    Returns:
        ((x, xold1, xold2, low, upp, u_prev) tensors of ``dtype`` on
        ``device``, k_next, the replayed history list).
    """
    d = np.load(path)
    state = tuple(torch.as_tensor(d[n], dtype=dtype, device=device)
                  for n in ("x", "xold1", "xold2", "low", "upp", "u_prev"))
    history = [
        {"iter": int(i), "obj": float(o), "con": [float(v) for v in c],
         "step": float(s), "cg_iters": int(g)}
        for i, o, c, s, g in zip(d["hist_iter"], d["hist_obj"],
                                 d["hist_con"], d["hist_step"], d["hist_cg"])
    ]
    return state, int(d["k_next"]), history


def assembler_state_from_numpy(asm, Kq, masks, W=None, otf=None, sym=None):
    """Install per-level tables in a port assembler (in place).

    Args:
        asm: port ``multigrid.GMGAssembler`` or ``GMGAssembler3D`` with
            the same level sizes.
        Kq: per level, (nq, ndpe, ndpe) unit element matrices.
        masks: per level, (nd, [nz,] ny, nx) bool Dirichlet masks.
        W: per level, the K1 (nd*nd*9, 4, nq) or K3 (nd*nd*27, 8, nq)
            weights; None folds them from ``Kq``
            (``ops.fused_assemble.assembly_weights[3d]``).
        otf: 3D ``elem_path="otf"``: per level, the JAX assembler's
            ``static_levels[l][7]`` — ``(w3, wd, maskf_k1)``, of which
            ``(w3, wd)`` are read (the mask comes from ``masks``) — or
            None on its assembled levels; None folds the K6 tables from
            ``Kq`` (``ops.otf3d.otf_weights``).
        sym: coefficient storage to install (the JAX ``pallas_sym``);
            None keeps the assembler's.

    Returns:
        ``asm``.
    """
    if not len(Kq) == len(masks) == len(asm.static_levels):
        raise ValueError(
            f"{len(Kq)} Kq / {len(masks)} masks for "
            f"{len(asm.static_levels)} levels"
        )
    if W is not None and len(W) != len(Kq):
        raise ValueError(f"{len(W)} W for {len(Kq)} levels")
    if otf is not None and len(otf) != len(Kq):
        raise ValueError(f"{len(otf)} OTF entries for {len(Kq)} levels")
    put = lambda a: torch.as_tensor(
        np.asarray(a), dtype=asm.dtype, device=asm.device
    ).contiguous()
    for li, st in enumerate(asm.static_levels):
        Kq_l = np.asarray(Kq[li], np.float64)
        mask = np.array(masks[li], dtype=bool)  # a writable copy
        if Kq_l.shape != tuple(st.Kq.shape) or mask.shape != tuple(
            st.mask.shape
        ):
            raise ValueError(f"level {li}: shapes do not match the port's")
        fold = assembly_weights if len(st.shape) == 2 else assembly_weights3d
        W_l = (fold(st.op.plan, Kq_l, asm.nd, Kq_l.shape[0])
               if W is None else W[li])
        st = asm.static_levels[li] = st._replace(
            mask=torch.as_tensor(mask, device=asm.device),
            maskf=put((~mask).astype(np.float64)),
            Kq=put(Kq_l),
            W=put(W_l),
        )
        if otf is not None and (otf[li] is None) != (st.otf is None):
            raise ValueError(f"level {li}: OTF tables do not match the "
                             f"port's route")
        if st.otf is not None:
            asm.static_levels[li] = st._replace(
                otf=asm.otf_tables(st) if otf is None else
                (put(otf[li][0]), put(otf[li][1])))
    if sym is not None:
        asm.sym = bool(sym)
    return asm
