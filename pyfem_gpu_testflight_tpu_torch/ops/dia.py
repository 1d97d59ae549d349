"""dof-vector reorderings between interleaved and planar layouts.

Port of ``interleave_to_planar`` / ``planar_to_interleave`` from
``pyfem_gpu_testflight_tpu/ops/dia.py``; the DIA operators there belong
to the unstructured slice.
"""

from __future__ import annotations

__all__ = ["interleave_to_planar", "planar_to_interleave"]


def interleave_to_planar(u, nd):
    """dof reorder (node-major, comp-minor) -> (comp, node) planes."""
    return u.reshape(-1, nd).t().reshape(-1)


def planar_to_interleave(u, nd):
    return u.reshape(nd, -1).t().reshape(-1)
