"""PyTorch port, sharded AMG-PCG on CPU gloo ranks.

The torque-arm system of the JAX test (tests/test_sharded_amg.py: the
12x80 synthesized arm, 1,920 dof, two levels) and the 24x160 arm (7,680
dof, three levels: a sharded level feeding a sharded level) are solved
by ``ShardedAMGPCG`` on 2 and 4 spawned gloo ranks (the rank program is
``tests/torch_dist.py``); every level's product is U1 on the rank's row
block (its plain version here):

* against the JAX ``amg_pcg`` in float64 (rel < 1e-9, iterations within
  1) and the host ``spsolve`` (rel < 1e-8);
* the fine level is sharded, at least one level is (on the deeper arm,
  two);
* the one-shot ``sharded_amg_pcg`` at rtol 1e-8 against ``spsolve``
  (rel < 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.sparse.linalg import spsolve

from pyfem_gpu_testflight_tpu import unstructured as ju

from pyfem_gpu_testflight_tpu_torch.examples.torque_arm import (
    arm_model, synthesize_arm_inp,
)

import torch_dist
import torch_threads  # noqa: F401  (one torch thread per worker)

WORLDS = (2, 4)
ARMS = {"arm": (12, 80), "arm_deep": (24, 160)}


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """Per arm: K, b, coordinates, the JAX amg_pcg and spsolve answers."""
    out = {}
    for name, (nr, nt) in ARMS.items():
        inp = synthesize_arm_inp(
            str(tmp_path_factory.mktemp("arm") / "a.inp"), nr=nr, nt=nt)
        model, X = arm_model(inp, device="cpu")[:2]
        K = model.assemble_scipy(model.element_jacobian(1.0))
        K, b = model.bc.apply_scipy(K, model.compute_rhs().numpy())
        x0, k0, _ = ju.amg_pcg(K, b, nd=2, coords=X, rtol=1e-10,
                               dtype=jnp.float64, precond_dtype=jnp.float64)
        out[name] = (K, b, X, np.asarray(x0), int(k0),
                     spsolve(K.tocsr(), b))
    return out


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, systems):
    outs = torch_dist.spawn(torch_dist.sharded_amg_ranks, request.param,
                            {name: s[:3] for name, s in systems.items()})
    return {name: [o[name] for o in outs] for name in systems}


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_sharded_amg_matches_single_device(ranks, systems, arm):
    _, _, _, x0, k0, xd = systems[arm]
    outs = ranks[arm]
    r = outs[0]
    assert r["fine_sharded"]
    assert sum(r["sharded"]) >= (2 if arm == "arm_deep" else 1)
    assert abs(r["k"] - k0) <= 1, (r["k"], k0)
    assert _rel(r["x"], x0) < 1e-9
    assert _rel(r["x"], xd) < 1e-8
    # every rank stops at the same iteration with the same solution
    assert {o["k"] for o in outs} == {r["k"]}
    for o in outs[1:]:
        np.testing.assert_array_equal(o["x"], r["x"])


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_sharded_amg_oneshot_wrapper(ranks, systems, arm):
    xd = systems[arm][5]
    assert _rel(ranks[arm][0]["oneshot"], xd) < 1e-6
