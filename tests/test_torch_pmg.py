"""PyTorch port, p-multigrid for tet10/brick20 lattices on CPU (float64).

Gates, against the JAX package's ``pmg.py`` and the port's own direct
solve:

* the lattice offsets (``mesh._BRICK20_OFFSETS``, ``_tet10_offsets``)
  equal the JAX package's;
* the scatter-free lattice matvec equals the generic segment-sum
  ``elem_matvec`` and JAX's ``PMG._lattice_matvec`` within 1e-12
  (relative), for tet10 and brick20;
* ``_inv_diag`` and the power-iteration ``cheb_lam`` equal JAX's within
  1e-10;
* ``solve(method="pmg", rtol=1e-10)`` at 9^3 takes JAX's PCG iteration
  count with the solution within 1e-8 (relative) of JAX's, and, with
  the default corner hierarchy, is within 1e-8 of the port's direct
  solve (the JAX gate ``test_pmg_matches_direct``);
* iteration counts stay bounded under refinement (9^3 -> 13^3, JAX's
  ``k13 <= k9 + 4``), and a RAMP-penalized (p=3) solve matches direct;
* a renumbered ``conn`` takes the generic route and gives the lattice
  route's solution; the refusals (hex8, even extents, nonzero Dirichlet
  values) raise ``ValueError``, a JAX TPU knob in ``gmg_options``
  ``TypeError``; ``compliance(solver="pmg")`` equals the direct
  solve's.

The JAX reference solve compiles JAX's own ``PMG._step`` with a
one-level corner hierarchy (``gmg_options=dict(min_n=5)``: the 5^3
corner grid solved by its dense inverse) on the same corner planes as
the port's (K3's plain version, held to JAX's assembly in
``test_torch_assemble3d.py``), handed to ``_step`` through its ``asm``
attribute, and with the generic element matvec (``_lat_off = None``;
the lattice form is held to JAX's separately): compiling JAX's XLA
corner hierarchy and eight unrolled lattice matvecs costs about a
minute per element type.  The port solves the same configuration on its
own lattice route.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import assembly as jassembly
from pyfem_gpu_testflight_tpu import mesh as jmesh
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.ops.stencil import Stencil3D as JStencil3D

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import mesh as tmesh
from pyfem_gpu_testflight_tpu_torch.ops.fused_smooth import (
    as_full_planes_3d,
)

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"
ETYPES = ["tet", "brick20"]
ENAME = {"tet": "tet10", "brick20": "brick20"}
ONE_LEVEL = dict(gmg_options=dict(min_n=5))


def _problem(et, n):
    c = pt.ProblemCreator(n, n, n, element_type=et)
    return c.create_linear_elasticity_problem()


def _model(et, n, p=0.0, conn=None, **pmg):
    conn0, X, fixed, force = _problem(et, n)
    m = pt.LinearElasticity(ENAME[et], X, conn0 if conn is None else conn,
                            fixed, None, force, p=p, device=DEV)
    return m.attach_pmg(n, n, n, **pmg)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class _CornerLevel:
    """Stands in for a JAX ``GMGAssembler3D`` of one level: ``assemble``
    builds the JAX ``Level`` of the port's corner planes (the density is
    1 everywhere) with its dense inverse, inside ``_step``'s trace."""

    def __init__(self, port_pmg):
        _gmg, lv = port_pmg.asm.assemble(torch.ones(
            int(np.prod(port_pmg.cshape)), dtype=torch.float64))
        nd, shape = lv.nd, lv.shape
        self.op = JStencil3D(shape[2], shape[1], shape[0], nd)
        self.coeff = jnp.asarray(as_full_planes_3d(lv.coeff, nd).reshape(
            (nd, nd, 3, 3, 3) + shape).numpy())
        self.mask = jnp.asarray(lv.mask.numpy())
        self.shape, self.nd = shape, nd

    def assemble(self, rho):
        lv = jmg.Level(self.op, self.coeff, self.mask, self.shape, self.nd)
        lv.dense_factor()
        return jmg.GMG([lv]), lv


@functools.lru_cache(maxsize=None)
def _jax_model(et, one_level=False):
    conn, X, fixed, force = _problem(et, 9)
    m = fem.LinearElasticity(ENAME[et], np.asarray(X), np.asarray(conn),
                             np.asarray(fixed), None, force)
    m.attach_pmg(9, 9, 9, **(ONE_LEVEL if one_level else {}))
    return m


@functools.lru_cache(maxsize=None)
def _jax_solve(et):
    """JAX's ``PMG.solve`` at 9^3, rho = 1, rtol 1e-10 on the one-level
    corner hierarchy: (x, iterations, cheb_lam)."""
    p = _jax_model(et, one_level=True)._pmg
    assert len(p.asm.sizes) == 1
    p.asm = _CornerLevel(_model(et, 9, **ONE_LEVEL)._pmg)
    p._lat_off = None
    x, _b, k, _rn = p.solve(rtol=1e-10)
    return np.asarray(x), int(k), float(p._cheb_lam)


def test_lattice_offsets_match_jax():
    np.testing.assert_array_equal(tmesh._BRICK20_OFFSETS,
                                  jmesh._BRICK20_OFFSETS)
    np.testing.assert_array_equal(tmesh._tet10_offsets(),
                                  jmesh._tet10_offsets())


@pytest.mark.parametrize("et", ETYPES)
def test_lattice_matvec_matches_generic_and_jax(et):
    m = _model(et, 9)
    pmg = m._pmg
    assert pmg._lat_off is not None  # the creator lattice is recognised
    rng = np.random.default_rng(5)
    Ke = m.element_jacobian(torch.as_tensor(0.3 + 0.7 * rng.random(
        m.nnodes)))
    v = torch.as_tensor(rng.standard_normal(m.ndof))
    y_lat = pmg._lattice_matvec(Ke, v)
    y_gen = m.matvec(Ke, v)
    assert _rel(y_lat, y_gen) <= 1e-12
    jp = _jax_model(et)._pmg
    y_jax = jp._lattice_matvec(jnp.asarray(Ke.numpy()), jnp.asarray(v.numpy()))
    assert _rel(y_lat, y_jax) <= 1e-12
    # the generic JAX route on the same Ke agrees too
    y_jgen = jassembly.elem_matvec(jnp.asarray(Ke.numpy()),
                                   jp.model.conn_dof, jnp.asarray(v.numpy()),
                                   jp.model.ndof)
    assert _rel(y_gen, y_jgen) <= 1e-12


@pytest.mark.parametrize("et", ETYPES)
def test_inv_diag_and_power_lam_match_jax(et):
    m = _model(et, 9, **ONE_LEVEL)
    pmg = m._pmg
    Ke = m.element_jacobian(1.0)
    inv = pmg._inv_diag(Ke)
    jinv = _jax_model(et)._pmg._inv_diag(jnp.asarray(Ke.numpy()))
    assert np.abs(inv.numpy() - np.asarray(jinv)).max() <= 1e-10 * np.abs(
        np.asarray(jinv)).max()
    lam = pmg._power_lam(Ke, inv)
    _x, _k, jlam = _jax_solve(et)
    assert abs(lam - jlam) <= 1e-10 * abs(jlam)


@pytest.mark.parametrize("et", ETYPES)
def test_solve_matches_jax(et):
    m = _model(et, 9, **ONE_LEVEL)
    u = m.solve(method="pmg", rtol=1e-10)
    x_ref, k_ref, _lam = _jax_solve(et)
    assert m.last_solve_stats["iters"] == k_ref
    assert _rel(u.numpy(), x_ref) <= 1e-8


@pytest.mark.parametrize("et", ETYPES)
def test_pmg_matches_direct(et):
    m = _model(et, 9)
    assert len(m._pmg.asm.sizes) == 2  # 5^3 -> 3^3 corner V-cycle
    u = m.solve(method="pmg", rtol=1e-10)
    stats = m.last_solve_stats
    assert stats["method"] == "pmg" and stats["iters"] >= 2, stats
    u_dir = m.solve(method="direct")
    assert _rel(u.numpy(), u_dir.numpy()) <= 1e-8


def test_iterations_bounded_under_refinement():
    ks = {}
    for n in (9, 13):
        m = _model("brick20", n)
        m.solve(method="pmg", rtol=1e-8)
        ks[n] = m.last_solve_stats["iters"]
    assert ks[13] <= ks[9] + 4, ks


def test_pmg_ramp_penalized():
    """rho ~ U[0.3, 1], RAMP p = 3 (JAX's test_pmg_ramp_penalized)."""
    m = _model("tet", 9, p=3.0)
    rho = torch.as_tensor(0.3 + 0.7 * np.random.RandomState(5).rand(
        m.nnodes))
    u = m.solve(method="pmg", rho=rho, rtol=1e-10)
    u_dir = m.solve(method="direct", rho=rho)
    assert _rel(u.numpy(), u_dir.numpy()) <= 1e-8


def test_renumbered_conn_takes_generic_route():
    conn = _problem("brick20", 9)[0]
    perm = np.random.default_rng(3).permutation(conn.shape[0])
    m_lat = _model("brick20", 9)
    m_gen = _model("brick20", 9, conn=np.asarray(conn)[perm])
    assert m_lat._pmg._lat_off is not None and m_gen._pmg._lat_off is None
    u_lat = m_lat.solve(method="pmg", rtol=1e-10)
    u_gen = m_gen.solve(method="pmg", rtol=1e-10)
    assert (m_gen.last_solve_stats["iters"]
            == m_lat.last_solve_stats["iters"])
    assert _rel(u_gen.numpy(), u_lat.numpy()) <= 1e-10


@pytest.mark.parametrize("case", ["hex8", "even", "dirichlet", "tpu_knob"])
def test_refusals(case):
    if case == "hex8":
        conn, X, fixed, force = pt.ProblemCreator(
            5, 5, 5, element_type="block").create_linear_elasticity_problem()
        m = pt.LinearElasticity("hex8", X, conn, fixed, None, force,
                                device=DEV)
        with pytest.raises(ValueError, match="hex8"):
            m.attach_pmg(5, 5, 5)
        return
    conn, X, fixed, force = _problem("brick20", 5)
    if case == "even":
        # three unreferenced nodes make 128 = 4 * 4 * 8 lattice nodes
        X = np.concatenate([X, X[-3:]])
        m = pt.LinearElasticity("brick20", X, conn, fixed, None, force,
                                device=DEV)
        with pytest.raises(ValueError, match="odd n"):
            m.attach_pmg(4, 4, 8)
        with pytest.raises(ValueError):
            m.attach_pmg(5, 5, 5)  # 125 lattice nodes for 128
        with pytest.raises(RuntimeError, match="attach_pmg"):
            m.solve(method="pmg")
        return
    if case == "tpu_knob":  # the JAX package's TPU tiling knobs
        m = pt.LinearElasticity("brick20", X, conn, fixed, None, force,
                                device=DEV)
        with pytest.raises(TypeError, match="pallas_smooth"):
            m.attach_pmg(5, 5, 5, gmg_options=dict(pallas_smooth=True))
        return
    m = pt.LinearElasticity("brick20", X, conn, fixed,
                            np.ones(len(fixed)), force, device=DEV)
    with pytest.raises(ValueError, match="zero Dirichlet"):
        m.attach_pmg(5, 5, 5)


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_compliance_pmg_equals_direct(physics):
    if physics == "elasticity":
        m = _model("brick20", 9)
    else:
        conn, X, fixed = pt.ProblemCreator(
            9, 9, 9, element_type="tet").create_poisson_problem()
        m = pt.LinearPoisson("tet10", X, conn, fixed, device=DEV,
                             gfunc=lambda x: torch.ones_like(x[..., 0]))
        m.attach_pmg(9, 9, 9)
    c_pmg, _u = m.compliance(1.0, solver="pmg")
    c_dir, _u = m.compliance(1.0, solver="direct")
    assert abs(float(c_pmg) - float(c_dir)) <= 1e-8 * abs(float(c_dir))
