"""PyTorch port, element sharding and the mesh functions (CPU, gloo).

Gates on 2 and 4 spawned gloo ranks (``parallel.launch.run_ranks``; the
rank programs are ``tests/torch_dist.py``, which imports no JAX):

* ``ShardedPoisson`` (21x17, g = x y) and ``ShardedElasticity`` (14x10)
  against the JAX ones on the 8-device virtual mesh (``make_mesh(8)``,
  JAX tests/test_sharding.py:26-56), rel <= 1e-10 in float64, and
  against the JAX direct solves at the JAX tests' tolerances;
* the element axis is split: each rank holds ceil(nelems / world)
  elements;
* the mesh functions: the neighbour exchange gives each rank its
  neighbours' slabs and zeros at the global ends (``ppermute``), the
  all-gather concatenates in rank order, the all-reduce sums (and
  takes the max) over ranks, and every rank's PCG stops at the same
  iteration;
* a rank that raises fails the run inside its timeout: the others,
  blocked in a collective, are ended, and ``run_ranks`` raises with the
  rank's traceback.
"""

import time

import jax
import numpy as np
import pytest

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu.parallel import (
    ShardedElasticity as JShardedElasticity,
    ShardedPoisson as JShardedPoisson,
    make_mesh as jmake_mesh,
)

import torch_dist
import torch_threads  # noqa: F401  (one torch thread per worker)

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX sharded and direct solutions of both problems (numpy)."""
    jax.config.update("jax_enable_x64", True)
    mesh8 = jmake_mesh(8)
    c = fem.ProblemCreator(nnodes_x=21, nnodes_y=17)
    conn, X, fixed = c.create_poisson_problem()
    mp = fem.LinearPoisson("quad4", X, conn, fixed,
                           gfunc=lambda x: x[..., 0] * x[..., 1])
    up, _ = JShardedPoisson(mesh8, X, conn, np.asarray(mp.bc.mask),
                            fem.get_element("quad4")).solve(
        np.ones(mp.nnodes), mp.compute_rhs(), rtol=1e-12)
    c2 = fem.ProblemCreator(nnodes_x=14, nnodes_y=10)
    conn2, X2, fixed2, force2 = c2.create_linear_elasticity_problem()
    me = fem.LinearElasticity("quad4", X2, conn2, fixed2, None, force2)
    ue, _ = JShardedElasticity(mesh8, X2, conn2, np.asarray(me.bc.mask),
                               fem.get_element("quad4")).solve(
        np.ones(me.nnodes), me.compute_rhs(), rtol=1e-12)
    return {"poisson": (np.asarray(up),
                        np.asarray(mp.solve(method="direct"))),
            "elasticity": (np.asarray(ue),
                           np.asarray(me.solve(method="direct")))}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request):
    world = request.param
    return world, torch_dist.spawn(torch_dist.sharding_ranks, world)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_sharded_poisson_matches_jax(ranks, jax_refs):
    _, outs = ranks
    u, k = outs[0]["poisson"]
    ju, ud = jax_refs["poisson"]
    assert k > 0
    assert _rel(u, ju) <= 1e-10
    np.testing.assert_allclose(u, ud, rtol=1e-8, atol=1e-10)


def test_sharded_elasticity_matches_jax(ranks, jax_refs):
    _, outs = ranks
    u, _ = outs[0]["elasticity"]
    ju, ud = jax_refs["elasticity"]
    assert _rel(u, ju) <= 1e-10
    np.testing.assert_allclose(u, ud, rtol=1e-7, atol=1e-9)


def test_element_shards_are_distributed(ranks):
    world, outs = ranks
    padded = outs[0]["poisson_padded"]
    assert {o["poisson_Xe_rows"] for o in outs} == {padded // world}


def test_exchange_gives_neighbours_and_zeros_at_the_ends(ranks):
    world, outs = ranks
    for r, o in enumerate(outs):
        want_lo = 0.0 if r == 0 else float(r - 1)     # rank r-1's "up"
        want_hi = 0.0 if r == world - 1 else -float(r + 1)
        assert (o["lo"] == want_lo).all() and (o["hi"] == want_hi).all()
        assert o["transport"] == "host"  # gloo stages through the host


def test_gather_and_reduce(ranks):
    world, outs = ranks
    for o in outs:
        np.testing.assert_array_equal(o["gather"],
                                      np.repeat(np.arange(world), 2))
        assert o["reduce"] == world * (world + 1) / 2
        assert o["max"] == world - 1


def test_every_rank_stops_at_the_same_iteration(ranks):
    _, outs = ranks
    assert len({o["poisson"][1] for o in outs}) == 1
    assert len({o["elasticity"][1] for o in outs}) == 1
    for o in outs[1:]:  # and every rank holds the same solution
        np.testing.assert_array_equal(o["poisson"][0], outs[0]["poisson"][0])


def test_a_failing_rank_ends_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="deliberate failure on rank 1"):
        torch_dist.spawn(torch_dist.raising_ranks, 3)
    assert time.monotonic() - t0 < 60.0
