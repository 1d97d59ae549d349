"""PyTorch port, the MMA optimizer (``opt/mma.py``) on CPU.

* ``device_update_body`` and ``device_update_body_multi`` (torch, no
  host sync: the JAX bracket ``while_loop`` is a masked 12-step loop)
  equal the JAX traced updates on seeded n=500 inputs, float64, to
  1e-12 — at k < 2 and k >= 2, with the constraint active and inactive,
  and with a constraint that drives the bracket to its 1e12 cap;
* the ``MMA`` optimizer's history (objective, constraint, step,
  multiplier) equals the JAX optimizer's on small analytic problems to
  1e-10, on the NumPy path, the torch device path and, with two
  constraints, the coordinate-sweep dual.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu.opt import mma as jmma

from pyfem_gpu_testflight_tpu_torch.opt import mma as tmma

torch.set_num_threads(2)

N = 500
TOL = 1e-12


def _inputs(seed, m=None, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.1, 0.9, N)
    xold1 = np.clip(x + rng.uniform(-0.05, 0.05, N), 0, 1)
    xold2 = np.clip(xold1 + rng.uniform(-0.05, 0.05, N), 0, 1)
    low, upp = x - rng.uniform(0.1, 0.5, N), x + rng.uniform(0.1, 0.5, N)
    g = rng.standard_normal(N)
    dc = (rng.uniform(0.5, 1.5, N) / N if m is None
          else rng.uniform(0.5, 1.5, (m, N)) / N)
    return dict(x=x, xold1=xold1, xold2=xold2, low=low, upp=upp, g=g,
                dc=dc * scale, lb=np.zeros(N), ub=np.ones(N))


def _rel(got, ref):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def _both(fn_j, fn_t, d, ci, k):
    order = ("x", "xold1", "xold2", "low", "upp", "g", "dc")
    ref = jax.jit(fn_j, static_argnums=())(
        *(jnp.asarray(d[n]) for n in order), jnp.asarray(ci),
        jnp.asarray(d["lb"]), jnp.asarray(d["ub"]), k)
    got = fn_t(*(torch.as_tensor(d[n]) for n in order),
               torch.as_tensor(ci), torch.as_tensor(d["lb"]),
               torch.as_tensor(d["ub"]), k)
    return got, ref


# (seed, k, ci): active constraint (ci > 0 at lam = 0), inactive (ci << 0),
# and a stiff one whose multiplier sits near the bracket's reach
_CASES = {"active_k5": (0, 5, 0.3), "active_k1": (1, 1, 0.3),
          "inactive": (2, 4, -5.0), "stiff": (3, 3, 1e3)}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_device_update_body_matches_jax(case):
    seed, k, ci = _CASES[case]
    d = _inputs(seed, scale=1e-6 if case == "stiff" else 1.0)
    got, ref = _both(jmma.device_update_body, tmma.device_update_body, d,
                     ci, k)
    for a, b in zip(got, ref):  # x_new, low, upp, lam, step
        assert _rel(a, b) <= TOL
    if case == "inactive":
        assert float(got[3]) == 0.0


@pytest.mark.parametrize("k", [1, 4])
def test_device_update_body_multi_matches_jax(k):
    d = _inputs(10 + k, m=2)
    ci = np.array([0.2, -0.1])
    got, ref = _both(jmma.device_update_body_multi,
                     tmma.device_update_body_multi, d, ci, k)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= TOL


def test_bracket_reaches_the_jax_hi():
    """The masked 12-step bracket stops where the JAX while_loop does,
    for a constraint still positive at hi = 1e12 (cap) and for one
    crossing at each decade."""
    for t in (0.5, 3.0, 7e4, 2e11, 1e13):
        con = lambda h, t=t: t - h  # positive until h >= t
        c0 = torch.tensor(1.0, dtype=torch.float64)
        lam = tmma._dual_root(lambda h: con(h), c0, torch.float64, "cpu")
        hi = 1.0
        while con(hi) > 0.0 and hi < 1e12:
            hi *= 10.0
        lo, h = 0.0, hi
        for _ in range(60):
            mid = 0.5 * (lo + h)
            lo, h = (mid, h) if con(mid) > 0.0 else (lo, mid)
        assert float(lam) == 0.5 * (lo + h)


class _Quad(jmma.Problem):
    """min sum c / (x + 0.1)  s.t.  w . x <= 0.4 n (tests/test_mma_device)."""

    def __init__(self, n=50, two=False):
        super().__init__(n, 2 if two else 1)
        rng = np.random.RandomState(0)
        self.c = rng.rand(n) + 0.5
        self.w = rng.rand(n) + 0.5
        self.w2 = rng.rand(n) + 0.5

    def getVarsAndBounds(self, x, lb, ub):
        x[:] = 0.5
        lb[:] = 0.0
        ub[:] = 1.0

    def evalObjCon(self, x):
        x = (x.numpy() if torch.is_tensor(x) else np.asarray(x, float))
        f = float(np.sum(self.c / (x + 0.1)))
        con = [0.4 * self.nvars - float(self.w.dot(x))]
        if self.ncon == 2:
            con.append(0.45 * self.nvars - float(self.w2.dot(x)))
        return 0, f, con

    def evalObjConGradient(self, x, g, A):
        x = (x.numpy() if torch.is_tensor(x) else np.asarray(x, float))
        g[:] = -self.c / (x + 0.1) ** 2
        A[0][:] = -self.w
        if self.ncon == 2:
            A[1][:] = -self.w2
        return 0


@pytest.mark.parametrize("device", [False, True])
@pytest.mark.parametrize("two", [False, True])
def test_mma_history_matches_jax(device, two):
    opts = {"max_iterations": 15, "verbose": False, "device": device}
    ref = jmma.MMA(_Quad(two=two), opts)
    ref.optimize()
    got = tmma.MMA(_Quad(two=two), opts)
    x = got.optimize()
    assert len(got.history) == len(ref.history) == 15
    for hg, hr in zip(got.history, ref.history):
        for key in ("obj", "step"):
            assert abs(hg[key] - hr[key]) <= 1e-10 * max(abs(hr[key]), 1.0)
        np.testing.assert_allclose(hg["con"], hr["con"], rtol=1e-10,
                                   atol=1e-10)
        np.testing.assert_allclose(hg["lam"], hr["lam"], rtol=1e-10,
                                   atol=1e-12)
    assert _rel(x, ref.x) <= 1e-10
