"""PyTorch port, kernel K1 (``ops/fused_assemble.py``) on CPU.

K1 replaces the Pallas ``assemble_pack_2d``; on a CPU tensor its
wrapper runs the plain PyTorch version, which is gated here against the
JAX package's XLA route for the same planes:
``Stencil2D.assemble_uniform(material_planes(rho), Kq)`` followed by
``bc_eliminate``, in float64 to 1e-12 relative.  The JAX side runs its
plain XLA path (the JAX package's own tests hold its Pallas kernel to
that path).  Inverse diagonals are compared on free dofs only: the port
stores ``rowm / diag`` (0 at fixed dofs), the XLA ``Level`` ``1 / diag``.
The port's own ``Stencil2D``, the plain reference, is held to the JAX
one method by method, and to plain K1.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import multigrid as jmg

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

torch.set_num_threads(2)

NX, NY = 33, 17


def _rho(seed=0):
    return np.random.default_rng(seed).uniform(0.2, 1.0, (NY, NX))


def _jax_fine_planes(physics, rho):
    """Fine-level (coeff_e, inv_diag, mask) from the JAX XLA route."""
    ja = jmg.GMGAssembler(NX, NY, 2.0, 1.0, physics, p=3.0,
                          dtype=jnp.float64)
    op, _xe, _conn, mask, _shape, Kq, _pal = ja.static_levels[0]

    @jax.jit
    def planes(rho):
        coeff = op.assemble_uniform(ja.material_planes(rho), Kq)
        ce = op.bc_eliminate(coeff, mask)
        d = op.diagonal(ce)
        return ce, 1.0 / jnp.where(d == 0, 1.0, d)

    ce, invd = planes(jnp.asarray(rho))
    nd = ja.nd
    return (np.asarray(ce).reshape(nd * nd * 9, NY, NX), np.asarray(invd),
            np.asarray(mask))


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_plain_k1_matches_xla_assembly(physics):
    rho = _rho()
    ce_ref, invd_ref, mask = _jax_fine_planes(physics, rho)
    ta = tmg.GMGAssembler(NX, NY, 2.0, 1.0, physics, p=3.0,
                          dtype=torch.float64)
    st = ta.static_levels[0]
    coeff, invd, lp = fa.assemble_pack_2d_plain(
        torch.as_tensor(rho), st.maskf, st.W, ta.N, nd=ta.nd, p=3.0,
        lp_dtype=torch.bfloat16,
    )
    scale = np.abs(ce_ref).max()
    assert np.abs(coeff.numpy() - ce_ref).max() <= 1e-12 * scale
    free = ~mask
    d = np.abs(invd.numpy() - invd_ref)[free]
    assert d.max() <= 1e-12 * np.abs(invd_ref[free]).max()
    assert np.all(invd.numpy()[mask] == 0.0)
    assert lp.dtype == torch.bfloat16 and torch.equal(
        lp, coeff.to(torch.bfloat16)
    )


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_stencil_reference_matches_jax(physics):
    """The port's Stencil2D (the plain reference of both kernels) equals
    the JAX one method by method in float64, and its eliminated planes
    equal plain K1's."""
    rho = _rho(3)
    ja = jmg.GMGAssembler(NX, NY, 2.0, 1.0, physics, p=3.0,
                          dtype=jnp.float64)
    jop, _xe, _conn, jmask, _shape, Kq, _pal = ja.static_levels[0]
    nd = ja.nd
    u = np.random.default_rng(4).standard_normal((nd, NY, NX))

    @jax.jit
    def ref(rho, u):
        coeff = jop.assemble_uniform(ja.material_planes(rho), Kq)
        ce = jop.bc_eliminate(coeff, jmask)
        return (coeff, ce, jop.diagonal(ce), jop.matvec(coeff, u),
                jop.bc_matvec(coeff, jmask, u), ja.material_planes(rho))

    coeff_r, ce_r, d_r, mv_r, bmv_r, Cq = (
        np.array(a) for a in ref(jnp.asarray(rho), jnp.asarray(u))
    )
    ta = tmg.GMGAssembler(NX, NY, 2.0, 1.0, physics, p=3.0,
                          dtype=torch.float64)
    st = ta.static_levels[0]
    op, ut = st.op, torch.as_tensor(u)
    coeff = op.assemble_uniform(torch.as_tensor(Cq), st.Kq)
    ce = op.bc_eliminate(coeff, st.mask)

    def close(got, want):
        got = got.numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

    close(coeff, coeff_r)
    close(ce, ce_r)
    close(op.diagonal(ce), d_r)
    close(op.matvec(coeff, ut), mv_r)
    close(op.bc_matvec(coeff, st.mask, ut), bmv_r)
    # elimination is what bc_matvec does, folded into the planes
    close(op.matvec(ce, ut), bmv_r)
    k1, _ = fa.assemble_pack_2d_plain(torch.as_tensor(rho), st.maskf, st.W,
                                      ta.N, nd=nd, p=3.0)
    close(k1, ce.reshape(nd * nd * 9, NY, NX).numpy())


def test_wrapper_takes_plain_path_on_cpu():
    ta = tmg.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                          dtype=torch.float32)
    st = ta.static_levels[0]
    rho = torch.as_tensor(_rho(1), dtype=torch.float32)
    a = fa.assemble_pack_2d(rho, st.maskf, st.W, ta.N, nd=2, p=3.0)
    b = fa.assemble_pack_2d_plain(rho, st.maskf, st.W, ta.N, nd=2, p=3.0)
    assert len(a) == 2 and all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        fa.assemble_pack_2d(rho, st.maskf[:1], st.W, ta.N, nd=2, p=3.0)
    with pytest.raises(ValueError):
        fa.assemble_pack_2d(rho.double(), st.maskf, st.W, ta.N, nd=2, p=3.0)


def test_hierarchy_levels_match_xla():
    """Every level of the port's assembled hierarchy (coarse densities
    by injection, masks by injection) matches the JAX hierarchy."""
    rho = _rho(2)
    ja = jmg.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                          dtype=jnp.float64)
    ta = tmg.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                          dtype=torch.float64)

    @jax.jit
    def levels(rho):
        gmg, _ = ja.assemble(rho)
        return [(lv.coeff_e, lv.inv_diag, lv.mask) for lv in gmg.levels], \
            gmg.levels[-1].dense_inv

    jl, jinv = levels(jnp.asarray(rho.reshape(-1)))
    gmg, _ = ta.assemble(torch.as_tensor(rho.reshape(-1)))
    assert len(jl) == len(gmg.levels) == 3
    for (ce, invd, mask), lv in zip(jl, gmg.levels):
        ce = np.asarray(ce).reshape(lv.coeff.shape)
        assert np.abs(lv.coeff.numpy() - ce).max() <= 1e-12 * np.abs(ce).max()
        free = ~np.asarray(mask)
        assert np.array_equal(lv.mask.numpy(), np.asarray(mask))
        d = np.abs(lv.inv_diag.numpy() - np.asarray(invd))[free]
        assert d.max() <= 1e-12 * np.abs(np.asarray(invd)).max()
    jinv = np.asarray(jinv)
    tinv = gmg.levels[-1].dense_inv.numpy()
    assert np.abs(tinv - jinv).max() <= 1e-10 * np.abs(jinv).max()
