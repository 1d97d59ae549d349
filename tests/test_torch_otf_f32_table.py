"""PyTorch port, K6's float32 body: the weight table it reads, on CPU.

``csrc/otf_3d.cu``'s f32 body computes the OTF operator per element
offset o: Z[o][q] = sum_k W_o[ca][q][k] x_e[k] over the 8 nodes m of the
element node - o (k = (cb, m)), then acc[ca] = sum_(o, q) B_(o,q) Z[o][q],
with W the table ``ops/otf3d.py::f32_table`` gathers from w3 and lays
out as (o, k, lane l, (ca, qq)) for q = 2 l + qq.  Here the
table is built from the JAX package's ``otf_weights`` and the per-offset
contraction, done in float64 numpy as the kernel orders it, is held
against the dense ``sum_j B_j (w3 @ Y)_j`` of the JAX kernel's
definition on the same random fields (nd=3 and nd=1, a ragged 5x4x3
grid), to 1e-12 of max.  The table holds every structurally nonzero
weight of w3 once.
"""

import numpy as np
import pytest
import torch

from pyfem_gpu_testflight_tpu.ops import pallas_otf3d as jotf

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import otf3d

import torch_threads  # noqa: F401  (one torch thread per worker)


def _jax_w3(nd):
    ta = tmg.GMGAssembler3D(5, 5, 5, 2.0, 1.0, 1.0,
                            "elasticity" if nd == 3 else "poisson",
                            dtype=torch.float64, device="cpu",
                            elem_path="otf")
    st = ta.static_levels[0]
    w3, _wd = jotf.otf_weights(st.op.plan, st.Kq.numpy(), nd, 8)
    return np.asarray(w3, np.float64)


@pytest.mark.parametrize("nd", [3, 1])
def test_f32_table_per_offset_product_matches_dense(nd):
    w3 = _jax_w3(nd)
    tab = otf3d.f32_table(torch.as_tensor(w3)).numpy()
    ws = (2 * nd + 3) // 4 * 4
    assert tab.shape == (8, 8 * nd, 4, ws)
    assert not tab[..., 2 * nd:].any()
    # every structurally nonzero weight once, nothing else
    assert np.count_nonzero(tab) == np.count_nonzero(w3)
    assert np.isclose(np.abs(tab).sum(), np.abs(w3).sum(), rtol=1e-14)

    nz, ny, nx = 3, 4, 5
    rng = np.random.default_rng(3)
    x = rng.standard_normal((nd, nz, ny, nx))
    B = rng.uniform(0.1, 1.0, (64, nz * ny * nx))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1)))
    # dense: Y[(cb, d)] = x[cb](i + d - 1), acc = sum_j B_j (w3 @ Y)_j
    Y = np.stack([xp[cb, dz:dz + nz, dy:dy + ny, dx:dx + nx].reshape(-1)
                  for cb in range(nd) for dz in range(3) for dy in range(3)
                  for dx in range(3)])
    dense = np.stack([(B * (w3[ca] @ Y)).sum(0) for ca in range(nd)])
    # per offset, as the kernel: x_e[(cb, m)] = x[cb](i + m - o)
    per = np.zeros_like(dense)
    for o in range(8):
        oz, oy, ox = o >> 2, (o >> 1) & 1, o & 1
        xe = np.stack([
            xp[cb, 1 + mz - oz:1 + mz - oz + nz, 1 + my - oy:1 + my - oy + ny,
               1 + mx - ox:1 + mx - ox + nx].reshape(-1)
            for cb in range(nd) for m in range(8)
            for mz, my, mx in [(m >> 2, (m >> 1) & 1, m & 1)]])
        for ca in range(nd):
            for q in range(8):  # lane l = q // 2, entry ca * 2 + q % 2
                z = tab[o, :, q // 2, ca * 2 + q % 2] @ xe  # (nodes,)
                per[ca] += B[o * 8 + q] * z
    assert np.abs(per - dense).max() <= 1e-12 * np.abs(dense).max()
