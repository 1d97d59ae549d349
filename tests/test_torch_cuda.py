"""PyTorch port: the CUDA kernels against their plain versions on the card.

Needs an NVIDIA Hopper card and nvcc; marked ``slow`` (deselected by the
CPU tier) and skipped where CUDA is absent.  Run on the card with:

    python -m pytest --noconftest -m slow tests/test_torch_cuda.py -q

(``--noconftest``: the shared conftest imports JAX, which an install of
the port alone lacks.)  Tolerance: 1e-5 of max|plain| — both sides
read identical float32 / bf16 inputs and differ only in summation order
and FMA contraction.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.slow

NX, NY = 65, 33
TOL = 1e-5


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def level(dev):
    from pyfem_gpu_testflight_tpu_torch import multigrid

    a = multigrid.GMGAssembler(NX, NY, 2.0, 1.0, "elasticity", p=3.0,
                               device=dev)
    st = a.static_levels[0]
    rng = np.random.default_rng(0)
    rho = torch.as_tensor(rng.uniform(0.2, 1.0, (NY, NX)),
                          dtype=torch.float32, device=dev)
    return a, st, rho, rng


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def test_k1_matches_plain_on_card(level):
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a, st, rho, _ = level
    args = (rho, st.maskf, st.W, a.N)
    n0 = _cuda.launches["pyfem_assemble_2d"]
    ck, dk, lk = fa.assemble_pack_2d(*args, nd=2, p=3.0,
                                     lp_dtype=torch.bfloat16)
    cp, dp = fa.assemble_pack_2d_plain(*args, nd=2, p=3.0)
    torch.cuda.synchronize()
    assert _cuda.launches["pyfem_assemble_2d"] == n0 + 1
    free = st.maskf > 0
    assert _rel(ck, cp) <= TOL
    assert _rel(dk[free], dp[free]) <= TOL
    assert torch.equal(lk, ck.to(torch.bfloat16))


@pytest.mark.parametrize("variant", ["pre_bf16", "post_f32", "matvec"])
def test_k2_matches_plain_on_card(level, variant):
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    a, st, rho, rng = level
    ck, dk, lk = fa.assemble_pack_2d(rho, st.maskf, st.W, a.N, nd=2, p=3.0,
                                     lp_dtype=torch.bfloat16)
    f = lambda: torch.as_tensor(rng.standard_normal((2, NY, NX)),
                                dtype=torch.float32, device=rho.device)
    b = torch.where(st.mask, 0.0, f())
    x0 = torch.where(st.mask, 0.0, f())
    args, kw = {
        "pre_bf16": ((lk, dk, b, None), dict(niter=2, want_resid=True)),
        "post_f32": ((ck, dk, b, x0), dict(niter=3, want_resid=True)),
        "matvec": ((ck, dk, None, f()),
                   dict(niter=0, want_resid=True, neg_resid=True)),
    }[variant]
    got = fs.fused_sweeps_2d(*args, **kw)
    ref = fs.fused_sweeps_2d_plain(*args, **kw)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= TOL


def test_cuda_wrappers_refuse_float64(level):
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a, st, rho, _ = level
    with pytest.raises(TypeError):
        fa.assemble_pack_2d(rho.double(), st.maskf.double(), st.W.double(),
                            a.N.double(), nd=2, p=3.0)
