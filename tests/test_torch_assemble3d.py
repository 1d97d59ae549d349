"""PyTorch port, kernel K3 (``ops/fused_assemble.py``, 3D) on CPU.

K3 replaces the Pallas ``assemble_pack_3d`` with half-symmetric
storage; on a CPU tensor its wrapper runs the plain PyTorch version,
which is gated here against the JAX package's XLA route for the same
planes — ``Stencil3D.assemble_uniform(material_planes(rho), Kq)`` then
``bc_eliminate`` — on the kept planes of ``sym_planes_3d``, in float64
to 1e-12 relative, on a 9x7x5 grid with a random density, p=3, nd=3 and
nd=1.  Inverse diagonals are compared on free dofs (the port stores
``rowm / diag``, 0 at fixed dofs; the XLA ``Level`` ``1 / diag``).  The
full-storage form (``sym=False``) equals all 243 (27) eliminated planes
to the same tolerance.  The bf16 copy equals its own float64 planes
rounded.  The per-level unit
matrices and K3 weights of ``GMGAssembler3D`` equal the JAX
assembler's (1e-14 in float64, exactly in float32).  The table the CUDA
kernel stages (``fused_assemble.k3_table``: the structurally nonzero
weights in the order its unrolled plane loop consumes them, then N),
contracted in the kernel's order (per (a, b, dz) block of 9 planes,
element offset o outermost), equals the dense weights of the
JAX package's ``assembly_weights3d`` applied to the same random
materials (nd 3 and 1, both storages, 1e-12 in float64).  The
assemblers are built once per module (``_assemblers``).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops import pallas_assemble as jpa

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"
NX, NY, NZ = 9, 7, 5
L = (2.0, 1.5, 1.0)
_DTYPES = {"float64": (torch.float64, jnp.float64),
           "float32": (torch.float32, jnp.float32)}


@functools.lru_cache(maxsize=None)
def _assemblers(physics, dtype):
    tdt, jdt = _DTYPES[dtype]
    ja = jmg.GMGAssembler3D(NX, NY, NZ, *L, physics, p=3.0, dtype=jdt)
    ta = tmg.GMGAssembler3D(NX, NY, NZ, *L, physics, p=3.0, dtype=tdt,
                            device=DEV)
    return ja, ta


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_plain_k3_matches_xla_assembly(physics):
    ja, ta = _assemblers(physics, "float64")
    op, _xe, _conn, mask, _shape, Kq, _pal, _otf = ja.static_levels[0]
    nd = ja.nd
    rho = np.random.default_rng(5).uniform(0.2, 1.0, (NZ, NY, NX))
    with jax.disable_jit():
        coeff = op.assemble_uniform(ja.material_planes(jnp.asarray(rho)), Kq)
        ce = op.bc_eliminate(coeff, mask)
        d = op.diagonal(ce)
        invd_ref = np.asarray(1.0 / jnp.where(d == 0, 1.0, d))
    keep = [k for (k, *_r) in fs.sym_planes_3d(nd)]
    ce_ref = np.asarray(ce).reshape(nd * nd * 27, NZ, NY, NX)[keep]
    st = ta.static_levels[0]
    c, invd, lp = fa.assemble_pack_3d(
        torch.as_tensor(rho), st.maskf, st.W, ta.N, nd=nd, p=3.0,
        lp_dtype=torch.bfloat16,
    )
    assert c.shape == (len(keep), NZ, NY, NX)
    assert np.abs(c.numpy() - ce_ref).max() <= 1e-12 * np.abs(ce_ref).max()
    free = ~np.asarray(mask)
    di = np.abs(invd.numpy() - invd_ref)[free]
    assert di.max() <= 1e-12 * np.abs(invd_ref[free]).max()
    assert np.all(invd.numpy()[~free] == 0.0)
    assert lp.dtype == torch.bfloat16 and torch.equal(lp,
                                                      c.to(torch.bfloat16))


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_plain_k3_full_storage_matches_xla_assembly(physics):
    ja, ta = _assemblers(physics, "float64")
    op, _xe, _conn, mask, _shape, Kq, _pal, _otf = ja.static_levels[0]
    nd = ja.nd
    rho = np.random.default_rng(6).uniform(0.2, 1.0, (NZ, NY, NX))
    with jax.disable_jit():
        ce = op.bc_eliminate(
            op.assemble_uniform(ja.material_planes(jnp.asarray(rho)), Kq),
            mask,
        )
    ce_ref = np.asarray(ce).reshape(nd * nd * 27, NZ, NY, NX)
    st = ta.static_levels[0]
    args = (torch.as_tensor(rho), st.maskf, st.W, ta.N)
    c, invd, lp = fa.assemble_pack_3d(*args, nd=nd, p=3.0, sym=False,
                                      lp_dtype=torch.bfloat16)
    assert c.shape == ce_ref.shape
    assert np.abs(c.numpy() - ce_ref).max() <= 1e-12 * np.abs(ce_ref).max()
    assert torch.equal(lp, c.to(torch.bfloat16))
    kept, invd_sym = fa.assemble_pack_3d(*args, nd=nd, p=3.0)
    assert torch.equal(invd, invd_sym)
    assert torch.equal(c[[k for (k, *_r) in fs.sym_planes_3d(nd)]], kept)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_unit_matrices_and_weights3d_match(physics, dtype):
    ja, ta = _assemblers(physics, dtype)
    assert ta.sizes == ja.sizes == [(9, 7, 5), (5, 4, 3)]
    for (op, _xe, _c, mask, shape, Kq, _p, _o), st in zip(ja.static_levels,
                                                          ta.static_levels):
        Kq = np.asarray(Kq)
        W = jpa.assembly_weights3d(op.plan, Kq, ja.nd, 8).astype(Kq.dtype)
        assert st.shape == tuple(shape)
        for ref, got in ((Kq, st.Kq), (W, st.W)):
            got = got.numpy()
            assert got.dtype == ref.dtype
            if dtype == "float32":
                assert np.array_equal(got, ref)
            else:
                assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
        assert np.array_equal(st.mask.numpy(), np.asarray(mask))
        assert np.array_equal(ta.N.numpy(), np.asarray(ja.N))


def test_k3_wrapper_takes_plain_path_on_cpu():
    _ja, ta = _assemblers("elasticity", "float32")
    st = ta.static_levels[0]
    rho = torch.as_tensor(np.random.default_rng(1).uniform(
        0.2, 1.0, (NZ, NY, NX)), dtype=torch.float32)
    a = fa.assemble_pack_3d(rho, st.maskf, st.W, ta.N, nd=3, p=3.0)
    b = fa.assemble_pack_3d_plain(rho, st.maskf, st.W, ta.N, nd=3, p=3.0)
    assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        fa.assemble_pack_3d(rho, st.maskf[:1], st.W, ta.N, nd=3, p=3.0)
    with pytest.raises(ValueError):
        fa.assemble_pack_3d(rho.double(), st.maskf, st.W, ta.N, nd=3, p=3.0)
    with pytest.raises(ValueError):
        fa.assemble_pack_3d(rho, st.maskf, st.W, ta.N, nd=2, p=3.0)


@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_k3_table_contracted_as_the_kernel_matches_dense_weights(physics,
                                                                sym):
    ja, ta = _assemblers(physics, "float64")
    op, _xe, _conn, _mask, _shape, Kq, _pal, _otf = ja.static_levels[0]
    nd = ja.nd
    W = np.asarray(jpa.assembly_weights3d(op.plan, np.asarray(Kq), nd, 8))
    tab = fa.k3_table(torch.as_tensor(W), ta.N, nd, sym).numpy()
    planes = ([k for (k, *_r) in fs.sym_planes_3d(nd)] if sym
              else list(range(nd * nd * 27)))
    # 8 o x 8 q materials of 64 random nodes; dense: every weight of W
    S = np.random.default_rng(2).uniform(0.1, 1.0, (64, 8, 8))
    dense = np.einsum("koq,noq->kn", W[planes], S)
    # the kernel: per (a, b, dz) block of 9 (dy, dx) planes, per element
    # offset o, per stored plane of the block whose element o holds both
    # the node and its neighbour, the next 8 weights against Cq[o][0..7]
    got = np.zeros_like(dense)
    slot = {k: i for i, k in enumerate(planes)}
    wi = 0
    for blk in range(nd * nd * 3):
        for o in range(8):
            a = (o >> 2, (o >> 1) & 1, o & 1)
            for pl in range(9):
                k = blk * 9 + pl
                d = (blk % 3, pl // 3, pl % 3)
                if k in slot and all(0 <= ai + di - 1 <= 1
                                     for ai, di in zip(a, d)):
                    got[slot[k]] += S[:, o] @ tab[wi:wi + 8]
                    wi += 8
    assert wi == tab.size - 64
    assert np.array_equal(tab[wi:], ta.N.numpy().reshape(-1))
    assert np.abs(got - dense).max() <= 1e-12 * np.abs(dense).max()
    # every structurally nonzero weight of the stored planes, once
    assert np.count_nonzero(tab[:wi]) == np.count_nonzero(W[planes])
    if not sym:
        assert wi == 512 * nd * nd
