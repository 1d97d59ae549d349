"""Carry the reference package's GMG state into the port.

For this FEM system the "weights" are the problem data (``X``,
``conn``, ``dof_fixed``, ``nodal_force`` — plain numpy, passed to both
packages' constructors as they are), the nodal density, and the static
per-level tables a ``GMGAssembler`` / ``GMGAssembler3D`` computes at
setup: the unit element matrices ``Kq``, the K1 / K3 weights ``W`` and
the Dirichlet masks.

:func:`assembler_state_from_numpy` installs those tables, taken as
numpy from a JAX ``GMGAssembler`` or ``GMGAssembler3D``
(``np.asarray(asm.static_levels[l][5])`` for ``Kq``, ``[3]`` for the
mask), into a port assembler of the same grid, so both packages can run
from identical tables.  The port's
own setup reproduces them (tests/test_torch_tables.py), so this is a
test aid, not a dependency.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.fused_assemble import assembly_weights, assembly_weights3d

__all__ = ["assembler_state_from_numpy"]


def assembler_state_from_numpy(asm, Kq, masks, W=None):
    """Install per-level tables in a port assembler (in place).

    Args:
        asm: port ``multigrid.GMGAssembler`` or ``GMGAssembler3D`` with
            the same level sizes.
        Kq: per level, (nq, ndpe, ndpe) unit element matrices.
        masks: per level, (nd, [nz,] ny, nx) bool Dirichlet masks.
        W: per level, the K1 (nd*nd*9, 4, nq) or K3 (nd*nd*27, 8, nq)
            weights; None folds them from ``Kq``
            (``ops.fused_assemble.assembly_weights[3d]``).

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
        asm.static_levels[li] = st._replace(
            mask=torch.as_tensor(mask, device=asm.device),
            maskf=put((~mask).astype(np.float64)),
            Kq=put(Kq_l),
            W=put(W_l),
        )
    return asm
