"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Builds the port's CUDA kernels from ``pyfem_gpu_testflight_tpu_torch/
csrc``, holds each against its plain PyTorch version on the card, then
drives the port's main paths through the package's public entry
points — the 2D plane-stress GMG-PCG solve at 1025x513 nodes (1,051,650
dof) on its K1, element-matrix (K7) and half-symmetric (K1-sym/K2-sym)
routes, 2D topology optimization at the same width (Helmholtz filter
on K9, GMG state solves, MMA; ``opt.DeviceTopo``), the 3D hex8 GMG-PCG
solve at 65^3 nodes (823,875 dof) on its assembled route, its
on-the-fly route and with full coefficient storage, and the
general-mesh element path (K8 element stiffness, matrix-free
Jacobi-PCG) on a jittered 65^3 hex8 mesh, and the nonlinear Poisson
Newton solve at 1025^2 (1,050,625 dof; GMRES on K9's tangent planes,
a V-cycle of K1 levels and K2 smoothing as its preconditioner), and the
p-multigrid solve of brick20 elasticity on the 65^3 lattice (411,840
live dof; Chebyshev on the quadratic element operator, a corner-grid
V-cycle on K3/K5 levels) with its ``kernel="cuda"`` (K8), Chebyshev
corner smoother (K4) and tet10 33^3 lines, and 3D topology optimization
at 65x33x33 and 129x65x65 (K3 levels, K5 smoothing, K4 the state
operator and the Helmholtz filter's product; ``opt.DeviceTopo``), and
unstructured meshes from synthesized Abaqus .inp files: smoothed-
aggregation AMG-PCG on the 1,053,186-dof torque arm and the
212,355-dof C3D10 bracket (U1, the CSR product, on every level; K8) and
their topology loops, and U2 (the DIA product) — and
checks the answers
against float64 and scipy references.  Exits nonzero on any
failure; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The line before it lists each kernel's launches on its main path (the
counts are zeroed just before that path's solve and read just after),
its error against the plain version, its time, the plain version's
time, its bound and, where one PyTorch call computes the same function,
that call's time.

Phases:
1. device: require CUDA, print the card's name and power limit;
2. build the kernels (one nvcc per source, in parallel) and time it;
3. 2D kernels vs plain (K1 at 1025x513 and 65x33; K2 in every call form
   the main paths run, each one launch, at 1025x513 nd=2: bf16
   presmooth with its residual, bf16 postsmooth, f32 postsmooth with
   the residual, the matvec, the Chebyshev residual pass, and niter=8
   in two sweep groups), with times, device times, one-pass bounds,
   launches per call and the CSR matvec time; the V-cycle's three call
   forms on every coarser level of bench 2D (513x257 down to 9x5);
3a. 3D kernels vs plain, in half-symmetric and full coefficient storage
   (K3 at 65^3 and 9x7x5 for nd=3 and nd=1, K4 in every mode on f32 and
   bf16 planes, K5 presmooth+resid and postsmooth on bf16 and nu=4),
   with times and the CSR matvec time; then the stencil passes on every
   level of bench 3D, 65^3 down to 5^3 (``pass_levels``: device time,
   each against its plain version) and ptxas's registers and spills of
   ``sweep_3d_kernel`` and ``assemble_3d_kernel``;
3b. K6, the on-the-fly operator, vs plain at 65^3 (nd=3) and 9x7x5
   (nd=3 and nd=1): matvec, presmooth+resid and postsmooth (nu=2) with
   f32 and bf16 operands, presmooth+resid nu=4, compared pass by pass
   (``k6_passes``), with times, the flop bound and the CSR matvec time;
   the f32 body's device time on every level and ptxas's registers of
   ``otf_3d_kernel``;
3c. K7a/K7b (quad4 at 1025x513, 17x9 and a ragged 13x7) and K8 (hex8 at
   65^3, tet10 and brick20 on the 33^3 lattice, elasticity and Poisson)
   vs plain on jittered meshes, with times, both bounds and ptxas's
   registers and spills;
3d. K9 (the 2D stencil product) vs plain at 1025x513, 17x9 and 13x7:
   nd=1 (the Helmholtz filter's planes) and nd=2 (elasticity), float32
   and float64, with times, the bound and the CSR time of each form;
3e. K1-sym and K2-sym (half-symmetric 2D storage) vs plain at the same
   sizes, nd=2 and nd=1, K2-sym in every call form K2 runs (each one
   launch) on f32 and bf16 planes, with times, bounds and the CSR matvec
   time; bench 2D sym's V-cycle calls on every coarser level;
4. the 2D bench configuration (p=0, rho=1, Chebyshev-node nu=2, bf16
   smoother copy, flexible PCG, rtol 1e-6): iterations, launch counts,
   float64 true residual, single-shot and chained solve times, and where
   the time goes (CUDA-event phase times, device busy share from
   ``torch.profiler``), and one K2 launch per smoothing call (a run with
   every ``fused_sweeps_2d`` call counted);
4a. the 3D bench configuration (``bench.py --config 3d``: 65^3, p=0,
   rho=1, Chebyshev-node nu=2, bf16 smoother copy, flexible PCG, rtol
   1e-6, coarsest 3^3 solved densely), the same measures, the peak
   device memory of one assemble+solve, and the float32 solution within
   ``SOL64_TOL`` (max-abs, of max) of the float64-outer solution, where
   the same PCG on the bf16 operator (the control) is not (4a-4c);
4b. the same with ``elem_path="otf"`` (K6 on every level but the
   coarsest): iterations against 4a's and the solution's difference from
   4a's, the same measures;
4c. the same with ``sym=False`` (all 243 planes): iterations, true
   residual, K4/K5 launches on full planes;
4d. the 2D bench configuration with ``elem_path="cuda"`` (K7a on every
   level, K2 the V-cycle): iterations against phase 4's, K7a launches
   per level, true residual, the solution difference, times, hierarchy
   assembly and peak memory beside phase 4's;
4e. "bench 2D sym": the 2D bench configuration with ``sym=True``
   (K1-sym on every level, K2-sym in every V-cycle variant): iterations
   against phase 4's, launches (no full-storage K1/K2), one K2-sym launch
   per smoothing call, the breakdown and peak memory beside phase 4's;
5. ``LinearElasticity.solve(method="gmg")`` at 1025x513 (rho=0.6 and a
   seeded random rho, p=3);
5a. the same entry on hex8 at 65^3;
5b. the same with ``attach_structured_grid(..., elem_path="otf")``;
5c. ``LinearElasticity("hex8", kernel="cuda", float32).solve(
   method="cg", rtol=1e-6)`` on the jittered 65^3 mesh: K8 launches,
   CG iterations and host read-backs, element_jacobian and solve time,
   element_jacobian handing out K8's own buffer (no layout copy),
   where a CG iteration goes, float64 true residual against the
   ``kernel="einsum"`` solve's and the float32 floor, bit-identity of
   two solves, peak memory, K8 against its plain version on the
   solve's inputs;
5d. the same for ``LinearPoisson`` (g = 1), 274,625 dof;
5e. the same for ``LinearPoisson`` on a jittered quad4 1025x513 mesh
   (525,825 dof), K7b's main path;
6. at 257x129, p^T u against scipy's sparse direct solve;
6a. at 17^3 (p=3, seeded rho), the same against scipy;
6b. host scipy direct against the card's CG on jittered quad4 257x129
   (both models) and tet10/brick20 9^3 lattices: float64 by p^T u and
   relative L2, float32 ``kernel="cuda"`` against ``"einsum"`` by their
   float64 true residuals.
7. "topo": ``bench.py --config topo`` at its width (1025x513 quad4
   cantilever, p=3, Helmholtz r0=0.01, ``DeviceTopo(fixed_volume=0.4)``),
   2 warm-up and 20 timed MMA iterations (the bench's 40 cut for time):
   s/iteration, state and filter iteration counts, K1/K2/K9 launches and
   host read-backs per iteration, CUDA-event stage times, busy share,
   peak memory, the first iteration's float32 compliance against a
   float64-outer solve, and a run resumed at iteration 2 against the
   uninterrupted one, bit for bit;
8. "newton": ``bench.py --config newton`` at its width (1025^2 quad4,
   1,050,625 dof, float32, ``NonlinearPoisson.solve_nonlinear_fused(
   method="gmg")``: tol 2e-2, GMRES rtol 1e-2 and at most 40 iterations,
   at most 12 Newton iterations): Newton and GMRES iterations, the
   float64 true residual ratio, K1/K2/K9 launches (K9's float32 and
   float64 forms apart) and host read-backs, K1 on every level of the
   iterate's coefficient field, K2 on its finest level (the path's own
   residual) and its presmooth and postsmooth calls on every level,
   and K9 on the nonsymmetric tangent planes (float32) and the flux
   (float64) against their plain versions, single-shot and chained times, CUDA-event
   stage times of every Newton iteration, busy share, peak memory, and
   the 257^2 float32 solution against a float64 direct Newton
   (``NEWTON64_TOL``);
9. "quadratic": ``bench.py --config quadratic`` at its width (brick20
   on the 65^3 lattice, 411,840 live dof, float32, rho = 1, p = 0,
   ``attach_pmg(65, 65, 65)``, rtol 1e-6; einsum element matrices, the
   bench's): the live dof and element counts, PCG iterations (<= 12; the
   JAX bench run took 10), ``cheb_lam`` (within 2% of the JAX run's
   5.100), the recursive and the float64 true residual (<= 4x its float32
   floor), the solution against a float64-outer solve (``PMG64_TOL``),
   K3 on every corner level and K5 against their plain versions on the
   path's inputs, K3/K4/K5 launches by corner level, the lattice matvec
   against its bytes bound and the generic segment-sum route, stage
   times (CUDA events), single-shot and chained times, a solve split
   into set-up and PCG, busy share and peak memory; then the same model
   with the Chebyshev corner smoother (K4 held against plain), with
   ``kernel="cuda"`` (K8 once per solve, its Ke against the einsum Ke
   and its plain version) and the tet10 lattice at 33^3 (cut from 65^3
   for time: its six-class lattice route);
10. "topo3d": ``bench.py --config topo --topo-3d`` at its width (65x33x33
   hex8 block cantilever, 212,355 state dof, 70,785 design variables,
   p=3, float32, Chebyshev-node nu=2, bf16 smoother copy, half-symmetric
   storage, flexible PCG rtol 1e-6, Helmholtz r0=0.01 rtol 1e-6 on K4 at
   nd=1, ``DeviceTopo(fixed_volume=0.4)``), 2 warm-up and 40 timed MMA
   iterations (the bench's counts): s/iteration, state and filter
   iteration counts, K3/K4/K5 launches per iteration (K4's state
   operator and filter apart) and host read-backs, CUDA-event stage
   times, busy share, peak memory, compliance and the final volume
   (<= 0.405), the first iteration's float32 compliance against a
   float64-outer solve, a run resumed at iteration 2 against the
   uninterrupted one bit for bit, K4's nd=1 full-storage form on the
   filter's planes against plain with its times, bound and
   ``torch.sparse.mm`` time, K3 on every level and K5 on the fine level
   against plain on the loop's final density; then the same at n = 65
   (129x65x65,
   1,635,075 state dof; 2 + 10 iterations), and the 3D einsum route
   (``elem_path="einsum"``) at 33^3 in both storages beside the uniform
   route;
11. "unstructured": the torque arm synthesized at 257x2049 polar nodes
   (526,593 nodes, 1,048,576 CPS3 elements, 1,053,186 dof) written as an
   Abaqus .inp under ``build/chip_smoke/``, parsed (``InpParser``) and
   solved through ``LinearElasticity.solve(method="amg", rtol=1e-10)`` in
   float64: AMG-PCG on the card with the levels' products on U1 (the
   counts zeroed just before, read just after), the host set-up and PCG
   times, iterations, read-backs, the float64 true residual (<= 2e-10),
   a second solve at another density (no structural set-up, the same
   runner), a float32 V-cycle under the float64 CG, rigid-body modes
   against translations only, the PCG alone, ms per V-cycle, U1
   launches and device activities per V-cycle, the levels, busy share
   and peak memory, a float32 model at rtol 1e-6, the 129x1025 arm
   against host SuperLU (<= 1e-8 rel L2) and the topology loop at full
   width (``examples.torque_arm_topo``: 2 warm-up + 5 timed MMA
   iterations, one structural set-up, stages by wrappers); the C3D10
   bracket at n=33 (212,355 dof) on K8 (``kernel="cuda"``) with float32
   AMG-PCG to rtol 1e-6 (``max_offsets`` 32768), its float64 true
   residual, the modes, the n=17 float64 bracket against SuperLU and its
   topology loop (4 MMA iterations); U1 against plain on every AMG level
   of both lines in float32 and float64 and timed on each fine level; U2
   on the arm's fine matrix as DIA (float32, against U1 and timed) and
   on the 2D bench grid (``structured_dia_2d(1025, 513, 2)``: Jacobi-PCG
   on ``DiaOperator.bc_matvec`` counts its launches; against plain,
   timed with the L2 flushed);
12. "surface": the user-facing surface on the 1025x513 GMG solves.
   12a: the p=3 cantilever (1,051,650 dof, float32, rho ~ U[0.3, 1]) with
   bench 2D's GMG options through ``Assembler(model).solve(method="gmg",
   rtol=1e-6)``, then ``postprocess.quadrature_strains``,
   ``quadrature_stresses(u, rho)``, ``nodal_strains``, ``mass_matrix`` and
   ``lumped_mass``: CUDA-event times and peak memory of each, the float32
   results against float64 on the same u and an affine field's exact
   strains (each within ``FLOOR_FACTOR`` x u32 x max sum |grad N||u|),
   the lumped mass sum, and iterations, K1 and K2 launches against phase
   4's step at the same p and density (the solution bit for bit);
   12d: those stages under ``time_this`` (``timer_on``,
   ``timer_to_stdout``), ``saved_times`` holding each, each timer reading
   no less than the stage's CUDA-event time; 12b: ``LinearPoisson`` at
   1025x513 (525,825 dof, K1/K2 at nd=1): KS at pval 10 and 100 against
   max u, ``ks_adjoint_rhs``, ``solve_adjoint(method="gmg")`` (its
   float64 true residual <= 4 x its float32 floor) and the design
   gradient, and at 257x129 in float64 the gradient's directional
   derivative against a complex step (1e-12); 12c:
   ``natural_frequencies_device`` (float64 LOBPCG) against eigsh on the
   same lumped mass from 129x65 down to the first grid meeting rtol 1e-6,
   its iterations, operator applications and time, and
   ``natural_frequencies`` at 257x129 (Rayleigh quotient); 12e: every
   ported example's ``main`` once on the card at its default size (topo:
   ``--solver gmg``, 3 MMA iterations; K1, K2, K9 launched;
   performance_study ``--kernel cuda``: K8), VTK output in a temporary
   directory, printout in ``build/chip_smoke/example_*.log``.
13. "sharded": the multi-rank solvers (``parallel``).  13a, a world-1
   NCCL process group made and destroyed in the phase: bench 2D and
   bench 3D through ``ShardedGMG2D/3D`` (iterations
   against phases 4 and 4a, float64 true residual, one K2 launch per
   smoothing call or one K4 launch per pass, CUDA-event time,
   collectives per PCG iteration, peak memory), the model entry
   (``attach_sharded_grid``, ``solve(method="sharded_gmg")``,
   ``compliance``) at 1025x513 p=3 against its ``gmg``, ``ShardedAMGPCG``
   on phase 11's arm (iterations against phase 11's, true residual) and
   ``ShardedDeviceTopo`` at 1025x513 (2 + 3 MMA iterations) and
   65x33x33 (2 + 5) against ``DeviceTopo`` on the same options; 13b, two
   spawned ranks on the one card over gloo (kernels built before the
   spawn): the 2D, 3D and arm solves against 13a's (their launches
   counted from just before the solves to just after), then K2, K4 and
   U1 on those solves' halo-extended blocks and K9 on the sharded 2D
   filter's (nd = 1), nonzero inner halos, against their plain
   versions; 13c, ``parallel.dryrun_multichip(2)``.
14. "dirichlet": GMG solves with nonzero Dirichlet values through
   ``solve(method="gmg")`` (the rhs lift ``b = rhs - A_raw v`` through
   the fine level's un-eliminated operator), bench 2D's / 3D's GMG
   options (Chebyshev-node nu=2, bf16 smoother copy, flexible PCG, rtol
   1e-6).  14a, 1025x513: ``LinearPoisson`` (g = 1) with the x = 0 edge
   at T = 0.3 + 0.7 y / Ly on the uniform (K1/K2), ``sym=True``
   (K1-sym/K2-sym) and ``elem_path="cuda"`` (K7b) routes, and
   ``LinearElasticity`` (p = 3, rho ~ U[0.3, 1], seed 14) with ux =
   1e-3 (y / Ly - 0.5), uy = 0 there on the uniform route; 14b, 65^3
   hex8 (p = 0, rho = 1), both physics with the same values on the x = 0
   face, on the uniform half and full storage (K3/K5/K4) and
   ``elem_path="otf"`` (K6) routes.  Each line: the kernels of its route
   and the lift's product kernel (K9 in 2D, K4 in 3D, K6 on the OTF
   route) launched, the fixed entries equal to the values, the lifted b
   within ``REL_TOL`` of max|b| of a float64 plain lift, the float64
   true residual at most 4x its float32 floor, PCG iterations at most 2
   above the same model's zero-value solve, the lift's time and
   launches beside the solve's; 14b also the solution within
   ``SOL64_TOL`` of the float64-outer solve.  The lift's kernels against
   their plain versions on the lines' inputs: K9 at nd 1 and 2, float32
   (K1's all-free planes) and float64 (the plain float64 planes); K4 in
   matvec mode, float32, full storage, nd 1 and 3; K6 with an all-free
   mask, nd 1 and 3.  14c, bench 2D with nu_pre = nu_post = 8 (K2 in
   sweep groups): converged, the float64 true residual against
   ``f64_operator`` at most 4x its floor.  14d, the in-repo oracles
   (``tests/oracles``: plane stress 32x32, hex8 elasticity and Poisson
   8^3, tet10 and brick20 Poisson 7^3) against the float64 einsum route
   on the card (projection error <= 1e-10), and the ``kernel="cuda"``
   route (K7a / K8) in float32 by Jacobi-CG, its float64 true residual
   at most 4x max(rtol, its float32 floor).

``python3 chip_smoke.py --pass-levels [--root DIR]`` runs only
``pass_levels`` on the package under DIR (default: this checkout), so a
checkout of another commit is timed on the same inputs in the same call;
``--solution-floor [--root DIR]`` likewise runs only ``solution_floor``,
the readings ``SOL64_TOL`` is set from; ``--newton-floor`` only phase
8's 257^2 yardstick on four design vectors, the readings
``NEWTON64_TOL`` is set from; ``--newton`` only phase 8;
``--quadratic`` only phase 9; ``--topo3d`` only phase 10;
``--unstructured`` only phase 11; ``--surface`` only phase 12;
``--sharded`` only phase 13 (with its single-device yardsticks);
``--dirichlet`` only phase 14;
``--stencil-2d-kernels [--root DIR]`` only K2, K2-sym and K9, on the
package under DIR: every K2 and K2-sym call form at 1025x513 nd=2 and
1025^2 nd=1 and every K9 form (nd 1 and 2 in f32 and f64 at 1025x513,
newton's tangent and flux at 1025^2), each held against its plain
version, a repeat call bit-identical, launches per call, CUDA-event and
device times with the L2 flushed by a write (``l2_flush``), by a read
(``l2_flush_clean``) and back to back, the bound and the plain and
one-call PyTorch times; bench 2D's and bench 2D sym's V-cycle calls on
every coarser level, held and timed back to back;
what each flush costs a timed call; and bench 2D's, bench 2D sym's, 4d's and
newton's iterations, K2 launches, device time and busy share, and
topo's state iterations over 4 MMA iterations;
``--k2-witness [--root DIR]`` K2's and K2-sym's float32 calls against
the plain version in float64 (the one-pass call, the plain version and
the step-kernel chain, each one-pass call equal to the chain bit for
bit; Chebyshev-node damping, niter 1-8, nd 1 and 2, f32 and bf16
planes, small grids and seeds 0-3, bench 2D's and newton's finest
levels) and the nd=1 call forms at 1025^2 by both kernels;
``--quadratic-floor`` bench quadratic's
float32 solution against its float64-outer one on the bench load and
three seeded loads, the readings ``PMG64_TOL`` is set from;
``--assembly-kernels [--root
DIR]`` only ``assembly_kernels``: K1 on every level of bench 2D
(1025x513 down to 9x5) in both storages at nd 2 and 1, bench 2D's and
bench 2D sym's assemble+solve, K3 on every level of bench 3D (65^3
down to 3^3) in both storages at nd 3 and 1, every K8 form on phase
3c's inputs and ``element_jacobian(kernel="cuda")`` on 5c's model, each
kernel held against its plain version, all timed by device time.
The short kernels' times (K1, K1-sym, K2, K2-sym, K7, K8) are CUDA
events over back-to-back wrapper calls, with the profiler's device time
beside them; K9's forms, K2's newton matvec, K4's filter form and the
U1 and U2 forms whose operands fit in the 50 MB L2 are timed with the
L2 flushed before each call (``l2_flush``), their back-to-back times
beside them.  ``l2_flush`` writes its buffer, so the timed call also
writes back up to 50 MB of the flush's dirty lines; ``--stencil-2d-
kernels`` times after a read (``l2_flush_clean``) too.  Device time and busy shares sum the profiler's device
rows only (``device_rows``: kernels, copies, sets); a PyTorch
operator's own row repeats its kernels' time.

Float32 accuracy: the operator is ill-conditioned enough that a float32
solve stalls at the float32 rounding floor of its operator, about
u32 * || |A| |x| || / ||b|| in relative residual (u32 = 2^-24; measured
at 0.8-0.9 of that on CPU up to 257x129).  The float32 solves are held
to that floor.  The 1e-5 float64 targets are held by the same kernels
under a float64 outer PCG (the float32 V-cycle as preconditioner).

Bounds: the least time for the same work on an H100 SXM, the larger of
(bytes the function must move, each input read once and each output
written once) / 3.35 TB/s and (the float32 operations it needs) / 67
TFLOP/s (float64: / 34 TFLOP/s, K9's float64 forms); for the element stiffness only the upper triangle of the
symmetric Ke is counted (``stiffness_flops``).
K6's operations are the structurally nonzero ones (the dense count of
the TPU kernel's matmuls is printed beside it).
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
NX, NY = 1025, 513  # bench.py's headline grid, 1,051,650 dof
N3 = 65             # bench.py --config 3d: 65^3 nodes, 823,875 dof
REL_TOL = 1e-5      # kernel vs plain, relative to max|plain|
FLOOR_FACTOR = 4.0  # float32 true residual <= this x its rounding floor
# bench 3D's float32 solution against its float64-outer solution, max-abs
# of max.  Set from ``--solution-floor`` on an H100 (PERF.md section 2):
# the 24 sound readings (3 routes x 4 loads, this package's kernels and
# the previous commit's) lie in 9.6e-5..1.83e-3 (7.3e-4 at most on the
# bench load) and the same PCG on a bf16 operator, the control, reads
# 0.39 or more
SOL64_TOL = 2e-3
HBM_BYTES_S = 3.35e12  # H100 SXM device memory rate
F32_FLOP_S = 67e12     # H100 SXM float32 rate outside the tensor cores
F64_FLOP_S = 34e12     # H100 SXM float64 rate outside the tensor cores
BF16_FLOP_S = 989e12   # H100 SXM dense bf16 rate on the tensor cores
FAILS = []
DEVICE_MS = {}  # main path label -> device time of one assemble+solve
PASS_TIMES = {}  # level n -> {stencil pass: device ms} (pass_levels)


def log(*a):
    print(*a, flush=True)


def check(ok, what):
    log(("  ok   " if ok else "  FAIL ") + what)
    if not ok:
        FAILS.append(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, between=None):
    """Mean milliseconds per call from CUDA events (after a warm-up).
    With ``between`` (e.g. :func:`l2_flush`), it runs before each call,
    outside the timed span: each call is timed alone by its own events,
    and the median is returned.  ``between`` must keep the card busy
    longer than the host takes to launch ``fn``, so that the span holds
    the call's device work and not the host's launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    if between is not None:
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        for a, b in ev:
            between()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return float(np.median([a.elapsed_time(b) for a, b in ev]))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def dev_us(row):
    """A profiler row's own device time, microseconds."""
    return getattr(row, "self_device_time_total",
                   getattr(row, "self_cuda_time_total", 0.0))


def device_rows(prof):
    """The profiler's device activities (kernels, copies, sets): its rows
    of device type CUDA.  An operator's row (device type CPU) repeats the
    device time of the kernels it launched, so a sum over every row
    counts each PyTorch operator's kernels twice (the port's own
    kernels, launched outside any operator, once)."""
    import torch

    return [r for r in prof.key_averages()
            if r.device_type == torch.autograd.DeviceType.CUDA
            and dev_us(r) > 0]


def device_ms(fn, reps=20, sessions=3, between=None):
    """Milliseconds of device time per call, from ``torch.profiler`` (the
    kernels' own time, whatever the host's speed): the median over
    ``sessions`` profiler sessions of ``reps`` calls each.  A session that
    records no device time (seen now and then on the card) is left out;
    None when none records any (not measured).  ``between`` runs before
    each call; the device rows that a session of ``reps`` calls of it
    alone records are left out of the sum (None when no such session
    records any: its rows could not be told apart).  A session whose
    rows of ``between`` sum to less than its ``floor_ms`` a call (the
    least time its work can take) lost records, and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    skip = set()
    for _ in range(sessions if between is not None else 0):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                between()
            torch.cuda.synchronize()
        skip = {r.key for r in device_rows(prof)}
        if skip:
            break
    if between is not None and not skip:
        return None
    floor = getattr(between, "floor_ms", 0.0)
    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(sessions):
        with profile(activities=acts) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        total = sum(dev_us(r) for r in rows if r.key not in skip)
        extra = sum(dev_us(r) for r in rows if r.key in skip)
        if extra / reps / 1e3 < floor:
            continue
        if total > 0:
            got.append(total / reps / 1e3)
    return float(np.median(got)) if got else None


def l2_flush(dev):
    """A callable that evicts the card's L2 cache (50 MB on the H100) by
    writing a 1 GiB buffer, so that the call timed after it reads its
    operands from device memory, as its bytes bound assumes.  The write
    (~0.3 ms) outlasts the host's launch of a kernel wrapper (~0.04 ms),
    so the card runs the timed call as soon as the flush ends.  Its
    ``floor_ms`` is 90% of the write's time at the card's memory rate:
    a profiler session that records less of it lost records (its rows
    have read 0.10-0.33 ms a flush from one run to the next)."""
    import torch

    buf = torch.empty(256 << 20, dtype=torch.float32, device=dev)

    def flush():
        buf.fill_(1.0)

    flush.floor_ms = 0.9e3 * nbytes(buf) / HBM_BYTES_S
    return flush


def fms(v):
    """A time in ms for the log, or "not measured" (None)."""
    return "not measured" if v is None else f"{v:.4f}"


def verdict(met, measured=True):
    """How a design target came out in this run."""
    return "not measured" if not measured else "met" if met else "NOT met"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, flops, flop_s=F32_FLOP_S):
    """(bound_ms, bound_by) for the card's memory rate and the operations'
    rate (float32 by default)."""
    tb, tf = n_bytes / HBM_BYTES_S, flops / flop_s
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def rel_err(got, ref, where=None):
    d = (got.float() - ref.float()).abs()
    r = ref.float().abs()
    if where is not None:
        d, r = d[where], r[where]
    return float(d.max()), float(d.max() / r.max())


def problem(nx, ny, nz=None):
    from pyfem_gpu_testflight_tpu_torch import ProblemCreator

    c = ProblemCreator(nnodes_x=nx, nnodes_y=ny, nnodes_z=nz,
                       element_type="quad" if nz is None else "block")
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return conn, X, fixed, force, [float(X[:, k].max())
                                   for k in range(X.shape[1])]


def f64_operator(nx, ny, Lx, Ly, rho, p, dev):
    """float64 BC-eliminated planes by the plain path: (A., |A|., planes).

    A. is kernel K9 in float64 (the ``--accuracy-op xla64`` operator,
    bench.py:933-1007); |A|. , which only sets the float32 floor, stays
    on the plain stencil product."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops.stencil_matvec import (
        stencil_matvec_2d,
    )

    a = multigrid.GMGAssembler(nx, ny, Lx, Ly, "elasticity", p=p,
                               dtype=torch.float64, device=dev)
    st = a.static_levels[0]
    c, _ = fa.assemble_pack_2d_plain(
        rho.to(dtype=torch.float64, device=dev).reshape(ny, nx), st.maskf,
        st.W, a.N, nd=2, p=p,
    )
    c = c.reshape(2, 2, 3, 3, ny, nx)
    ca = c.abs()
    return ((lambda u: stencil_matvec_2d(c, u)),
            (lambda u: st.op.matvec(ca, u)), c)


def f64_operator_3d(n, L, rho, p, dev):
    """float64 3D planes by the plain path: (A., |A|., full planes) on
    the n^3 grid, or on an (nx, ny, nz) one."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nx, ny, nz = (n, n, n) if np.ndim(n) == 0 else n
    a = multigrid.GMGAssembler3D(nx, ny, nz, *L, "elasticity", p=p,
                                 dtype=torch.float64, device=dev)
    st = a.static_levels[0]
    c, _ = fa.assemble_pack_3d_plain(
        rho.to(dtype=torch.float64, device=dev).reshape(nz, ny, nx),
        st.maskf, st.W, a.N, nd=3, p=p,
    )
    c = fs.full_planes_3d(c, 3)
    ca = c.abs()
    return (lambda u: st.op.matvec(c, u)), (lambda u: st.op.matvec(ca, u)), c


def residuals(mv64, mvabs, b, x):
    """(float64 true relative residual, float32 rounding floor)."""
    import torch

    b64, x64 = b.to(torch.float64), x.to(torch.float64)
    bn = float(torch.linalg.norm(b64))
    true = float(torch.linalg.norm(b64 - mv64(x64))) / bn
    floor = 2.0 ** -24 * float(torch.linalg.norm(mvabs(x64.abs()))) / bn
    return true, floor


def accuracy_solve(gmg32, mv64, b, rtol=1e-11):
    """float64 flexible PCG, the float32 kernel V-cycle as preconditioner."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid

    pre = lambda r: gmg32.apply(r.to(torch.float32)).to(torch.float64)
    return multigrid.pcg(mv64, pre, b.to(torch.float64), rtol=rtol,
                         maxiter=200, flexible=True)


def stencil_csr(c, shape):
    """torch sparse CSR of full stencil planes (nd, nd, 3.., *shape).

    Rows and columns are planar dofs (component-major); entries that
    are zero or point off the grid are dropped.
    """
    import torch

    nd, dim = c.shape[0], len(shape)
    dev = c.device
    npl = int(np.prod(shape))
    idx = torch.meshgrid(*[torch.arange(n, device=dev) for n in shape],
                         indexing="ij")
    node = torch.arange(npl, device=dev).reshape(shape)
    rows, cols, vals = [], [], []
    for ca, cb in itertools.product(range(nd), range(nd)):
        for off in itertools.product(range(3), repeat=dim):
            v = c[(ca, cb) + off]
            ok = v != 0
            j = [g + o - 1 for g, o in zip(idx, off)]
            flat = torch.zeros_like(node)
            for g, n in zip(j, shape):
                ok &= (g >= 0) & (g < n)
                flat = flat * n + g
            rows.append(ca * npl + node[ok])
            cols.append(cb * npl + flat[ok])
            vals.append(v[ok])
    n = nd * npl
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (n, n),
    ).coalesce().to_sparse_csr()


def scipy_csr(c, shape):
    import scipy.sparse as sp

    A = stencil_csr(c, shape)
    n = A.shape[0]
    return sp.csr_matrix((A.values().cpu().numpy(),
                          A.col_indices().cpu().numpy(),
                          A.crow_indices().cpu().numpy()), shape=(n, n))


def library_matvec_ms(c, shape, x, dtype=None):
    """``torch.sparse.mm`` time of the same operator, CSR (float32, or
    ``dtype``) built outside the timed region (the yardstick; the port
    never calls it)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    A = stencil_csr(c.to(dtype), shape)
    xv = x.to(dtype).reshape(-1, 1)
    ms = cuda_ms(lambda: torch.sparse.mm(A, xv), 20)
    del A
    return ms


def jittered(X, seed, frac=0.1):
    """Interior nodes moved by a seeded uniform +-frac of the lattice
    spacing per coordinate; nodes on the bounding box stay, so the BCs
    and the loads keep their nodes (no uniform-geometry shortcut
    applies)."""
    X = np.array(X, dtype=np.float64)
    lo, hi = X.min(0), X.max(0)
    inner = ~(np.isclose(X, lo) | np.isclose(X, hi)).any(1)
    rng = np.random.default_rng(seed)
    for k in range(X.shape[1]):
        h = (hi[k] - lo[k]) / (len(np.unique(np.round(X[:, k], 9))) - 1)
        X[inner, k] += rng.uniform(-frac * h, frac * h, int(inner.sum()))
    return X


def elem_problem(dims, element_type, seed):
    """A jittered ProblemCreator elasticity problem (conn, X, fixed,
    force)."""
    from pyfem_gpu_testflight_tpu_torch import ProblemCreator

    c = ProblemCreator(*dims, element_type=element_type)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    return conn, jittered(X, seed), np.asarray(fixed), force


def make_model(pt, physics, etype, mesh, dtype, kernel, dev):
    """``LinearElasticity`` on ``mesh = (conn, X, fixed, force)``, or
    ``LinearPoisson`` (source 1, the x=0 nodes fixed) on its nodes; p=3."""
    import torch

    conn, X, fixed, force = mesh
    if physics == "elasticity":
        return pt.LinearElasticity(etype, X, conn, fixed, None, force, p=3.0,
                                   dtype=dtype, device=dev, kernel=kernel)
    nd = X.shape[1]
    return pt.LinearPoisson(etype, X, conn, fixed[::nd] // nd,
                            gfunc=lambda x: torch.ones_like(x[..., 0]),
                            p=3.0, dtype=dtype, device=dev, kernel=kernel)


def smooth_density(X, seed):
    """A seeded smooth nodal density in [0.3, 1]: the mean of three
    cosines with wave numbers up to one per domain length.  Used on the
    quadratic elements, whose shape functions are negative at some
    quadrature points: an interpolated U[0.3, 1] field there overshoots
    past RAMP's pole at rho = 1 + 1/p, which makes element matrices
    indefinite (and float32 CG diverge)."""
    rng = np.random.default_rng(seed)
    span = np.ptp(X, axis=0)
    Y = (X - X.min(0)) / np.where(span > 0, span, 1.0)
    t = sum(np.cos(2 * np.pi * Y @ rng.uniform(-1, 1, X.shape[1])
                   + rng.uniform(0, 2 * np.pi)) for _ in range(3))
    return 0.65 + 0.35 * t / 3


def density(etype, X, seed):
    """rho ~ U[0.3, 1] on the linear elements, smooth_density on the
    quadratic ones."""
    if etype in ("tet10", "brick20"):
        return smooth_density(X, seed)
    return np.random.default_rng(seed).uniform(0.3, 1.0, len(X))


def stiffness_flops(nn, nq, nd, dims, nelems):
    """float32 operations an element-stiffness function needs (a fused
    multiply-add counts 2), per element and quadrature point: the
    Jacobian (2 dims^2 nn), its inverse by cofactors (8 in 2D, 42 in
    3D), the shape gradients G (dims (2 dims - 1) nn), the scaled weight
    c = cq w detJ (2), then only the upper triangle of the symmetric Ke,
    ndpe (ndpe + 1) / 2 entries (ndpe = nd nn; the rest is a copy).
    Elasticity: mu c G_n and lam c G_n once per node (2 dims nn + 2),
    two multiply-adds per entry (mu c G_nb G_ma + lam c G_na G_mb into
    the sum), and per node pair G_n.G_m (2 dims - 1) and one
    multiply-add on each of its dims diagonal entries.  Poisson: c G_n
    once per node (dims nn) and a dims-term dot product into the sum
    per entry (2 dims)."""
    ndpe = nd * nn
    upper, pairs = ndpe * (ndpe + 1) // 2, nn * (nn + 1) // 2
    per = (2 * dims * dims * nn + (8 if dims == 2 else 42)
           + dims * (2 * dims - 1) * nn + 2)
    if nd > 1:
        per += 2 * dims * nn + 2 + 4 * upper + pairs * (4 * dims - 1)
    else:
        per += dims * nn + 2 * dims * upper
    return nelems * nq * per


def stiffness_pair(m, etype, physics, rho):
    """(kernel, plain, inputs): zero-argument calls of the element
    stiffness function that ``m.element_jacobian`` runs for ``etype`` and
    ``physics`` (K7a / K7b / K8) and of its plain version, on m's
    element coordinates and the RAMP material of ``rho`` (a tensor on
    m's device) in the kernels' layout, and those inputs."""
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek
    from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3

    XeT, cqT = m._XeT, m._cq_transposed(rho)
    elastic = physics == "elasticity"
    args = (XeT, cqT, m.mu, m.lam) if elastic else (XeT, cqT)
    if etype == "quad4":
        fk, fp = ((ek.elasticity_stiffness_quad4,
                   ek.elasticity_stiffness_quad4_plain) if elastic else
                  (ek.poisson_stiffness_quad4,
                   ek.poisson_stiffness_quad4_plain))
        kw = {}
    else:
        fk, fp = ((ek3.elasticity_stiffness_3d,
                   ek3.elasticity_stiffness_3d_plain) if elastic else
                  (ek3.poisson_stiffness_3d, ek3.poisson_stiffness_3d_plain))
        kw = dict(etype=etype)
    return (lambda: fk(*args, **kw)), (lambda: fp(*args, **kw)), (XeT, cqT)


def ptxas_table(log):
    """{kernel symbol: "N registers, S/L bytes spill stores/loads"} from
    nvcc -Xptxas -v output."""
    table, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            parts = line.replace(",", "").split()
            spill = f"{parts[4]}/{parts[8]} B spill stores/loads"
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[1].split("registers")[0].strip()
            table[name] = f"{regs} registers, {spill}"
            name = None
    return table


# (key, etype, ProblemCreator element_type, template tag in the symbol)
ELEM_FORMS = (
    ("K7a", "quad4", "quad", "stiffness_quad4_kernelILb1E"),
    ("K7b", "quad4", "quad", "stiffness_quad4_kernelILb0E"),
    ("K8 hex8 elasticity", "hex8", "block",
     "stiffness_3d_kernelILi8ELi8ELb1E"),
    ("K8 hex8 poisson", "hex8", "block", "poisson_elem_kernelILi8ELi8E"),
    ("K8 tet10 elasticity", "tet10", "tet",
     "stiffness_3d_kernelILi10ELi5ELb1E"),
    ("K8 tet10 poisson", "tet10", "tet", "poisson_elem_kernelILi10ELi5E"),
    ("K8 brick20 elasticity", "brick20", "brick20",
     "stiffness_3d_kernelILi20ELi27ELb1E"),
    ("K8 brick20 poisson", "brick20", "brick20",
     "stiffness_3d_kernelILi20ELi27ELb0E"),
)


def phase_kernels_elem(dev, pt, build_log):
    """Phase 3c: K7a, K7b and K8 against their plain versions on the
    card, on jittered meshes with p=3 and ``density``: quad4 at 1025x513
    and on the 17x9 / ragged 13x7 meshes, hex8 at 65^3, tet10 and
    brick20 on the 33^3 node lattice."""
    import torch

    regs = ptxas_table(build_log)
    sizes = {"quad4": [(NX, NY), (17, 9), (13, 7)], "hex8": [(N3,) * 3],
             "tet10": [(33,) * 3], "brick20": [(33,) * 3]}
    res = {}
    for key, etype, ctype, tag in ELEM_FORMS:
        physics = "poisson" if ("poisson" in key or key == "K7b") else \
            "elasticity"
        et = pt.get_element(etype)
        nd = et.ndims if physics == "elasticity" else 1
        worst = 0.0
        for i, dims in enumerate(sizes[etype]):
            conn, X, fixed, force = elem_problem(dims, ctype, SEED + 30 + i)
            m = pt.LinearElasticity(etype, X, conn, fixed, None, force,
                                    p=3.0, dtype=torch.float32, device=dev,
                                    kernel="cuda")
            rho = torch.as_tensor(density(etype, X, SEED + 31),
                                  dtype=torch.float32, device=dev)
            fk, fp, (XeT, cqT) = stiffness_pair(m, etype, physics, rho)
            got, ref = fk(), fp()
            torch.cuda.synchronize()
            ea, er = rel_err(got, ref)
            worst = max(worst, ea)
            tagd = f"{key} {'x'.join(map(str, dims))} ({m.nelems} elements)"
            log(f"{tagd}: rel {er:.2e} (abs {ea:.2e})")
            check(er <= REL_TOL, f"{tagd} within {REL_TOL:g}")
            check(torch.equal(got, fk()),
                  f"{tagd} repeat call bit-identical")
            if i:
                continue
            ms = cuda_ms(fk, 20)
            dms = device_ms(fk)
            pms = cuda_ms(fp, 3)
            flops = stiffness_flops(et.nnodes, et.nquads, nd, et.ndims,
                                    m.nelems)
            b_ms, b_by = bound(nbytes(XeT, cqT, got), flops)
            reg = [v for k, v in regs.items() if tag in k]
            res[key] = dict(max_abs_err=ea, ms=ms, device_ms=dms,
                            plain_ms=pms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None,
                            ptxas=reg[0] if reg else "not found",
                            bytes_ms=1e3 * nbytes(XeT, cqT, got) / HBM_BYTES_S,
                            flops_ms=1e3 * flops / F32_FLOP_S)
            log(f"{tagd}: kernel {ms:.4f} ms (device {fms(dms)}), plain "
                f"{pms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; bytes {res[key]['bytes_ms']:.4f} "
                f"ms, operations {res[key]['flops_ms']:.4f} ms at "
                f"{flops / 1e9:.2f} GFLOP), library none; ptxas "
                f"{res[key]['ptxas']}")
            del got, ref
        res[key]["max_abs_err"] = worst
    return res


def phase_kernels(dev, build_log):
    """Phase 3: each 2D kernel against its plain version on the card."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    rng = np.random.default_rng(SEED)
    res = {}
    for nx, ny in ((NX, NY), (65, 33)):
        a = multigrid.GMGAssembler(nx, ny, (nx - 1) / (ny - 1), 1.0,
                                   "elasticity", p=3.0, device=dev)
        st = a.static_levels[0]
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                              dtype=torch.float32, device=dev)
        args = (rho, st.maskf, st.W, a.N)
        kw = dict(nd=2, p=3.0, lp_dtype=torch.bfloat16)
        ck, dk, lk = fa.assemble_pack_2d(*args, **kw)
        cp, dp, _ = fa.assemble_pack_2d_plain(*args, **kw)
        torch.cuda.synchronize()
        free = st.maskf > 0
        ea, er = rel_err(ck, cp)
        ia, ir = rel_err(dk, dp, free)
        la, lr = rel_err(lk, cp)
        log(f"K1 {nx}x{ny}: planes rel {er:.2e} (abs {ea:.2e}), inv_diag "
            f"free rel {ir:.2e}, bf16 copy vs plain f32 rel {lr:.2e}")
        check(er <= REL_TOL, f"K1 {nx}x{ny} planes within {REL_TOL:g}")
        check(ir <= REL_TOL, f"K1 {nx}x{ny} inv_diag within {REL_TOL:g}")
        check(bool((dk[~free] == 0).all()), f"K1 {nx}x{ny} inv_diag 0 fixed")
        check(torch.equal(lk, ck.to(torch.bfloat16)),
              f"K1 {nx}x{ny} bf16 copy == its f32 planes rounded")
        check(lr <= 2.0 ** -8, f"K1 {nx}x{ny} bf16 copy within 1 bf16 ulp")
        if (nx, ny) == (NX, NY):
            b_ms, b_by = bound(nbytes(rho, st.maskf, st.W, a.N, ck, dk, lk),
                               k1_flops(2, False, rho.numel()))
            res["K1"] = dict(max_abs_err=max(ea, ia),
                             ms=cuda_ms(lambda: fa.assemble_pack_2d(
                                 *args, **kw), 50),
                             device_ms=device_ms(lambda: fa.assemble_pack_2d(
                                 *args, **kw)),
                             plain_ms=cuda_ms(
                                 lambda: fa.assemble_pack_2d_plain(
                                     *args, **kw), 10),
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             ptxas={k: short_ptxas(build_log, k) for k in
                                    ("assemble_2d_kernel",
                                     "assemble_2d_tiles")})
            fine = (ck, dk, lk, st.mask)
    log(f"K1 {NX}x{NY}: kernel {res['K1']['ms']:.4f} ms (device "
        f"{fms(res['K1']['device_ms'])}), plain "
        f"{res['K1']['plain_ms']:.4f} ms, bound {res['K1']['bound_ms']:.4f} "
        f"ms ({res['K1']['bound_by']})")

    ck, dk, lk, mask = fine
    field = lambda: torch.as_tensor(rng.standard_normal((2, NY, NX)),
                                    dtype=torch.float32, device=dev)
    b = torch.where(mask, 0.0, field())
    x0 = torch.where(mask, 0.0, field())
    forms, _w = k2_level_rows(ck, dk, lk, b, x0, field(), f"{NX}x{NY} nd=2",
                              lambda run: dict(ms=cuda_ms(run, 50),
                                               device_ms=device_ms(run)))
    _levels, _w, coarse_abs = k2_coarse_levels(dev, rng)
    head = forms["presmooth_resid_bf16"]
    res["K2"] = dict(max_abs_err=max([coarse_abs] + [
                         v["max_abs_err"] for v in forms.values()]),
                     ptxas={k: short_ptxas(build_log, k) for k in (
                         "sweeps_2d_kernel", "sweeps_2d_kernel_b2",
                         "smooth_2d_kernel")},
                     ms=head["ms"],
                     device_ms=head["device_ms"], plain_ms=head["plain_ms"],
                     bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                     library_ms=None, forms=forms)
    return res


def phase_kernels_k9(dev):
    """Phase 3d: K9 against its plain version at 1025x513, 17x9 and 13x7:
    nd=1 (the Helmholtz filter's K planes) and nd=2 (the float64
    accuracy operator's elasticity planes), float32 and float64, with
    times, the bound and the CSR time at full size."""
    import torch
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    rng = np.random.default_rng(SEED + 9)
    forms, worst = {}, 0.0
    for nx, ny in ((NX, NY), (17, 9), (13, 7)):
        conn, X, _f, _l, (Lx, Ly) = problem(nx, ny)
        filt = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float64,
                            device=dev).attach_structured_grid(nx, ny)
        rho = torch.as_tensor(rng.uniform(0.3, 1.0, nx * ny), device=dev)
        c2 = f64_operator(nx, ny, Lx, Ly, rho, 3.0, dev)[2]
        for name, c in (("nd1_f32", filt._coeffK), ("nd1_f64", filt._coeffK),
                        ("nd2_f32", c2), ("nd2_f64", c2)):
            dt = torch.float32 if name.endswith("f32") else torch.float64
            c = c.to(dt).contiguous()
            nd = c.shape[0]
            u = torch.as_tensor(rng.standard_normal((nd, ny, nx)), dtype=dt,
                                device=dev)
            got = sm.stencil_matvec_2d(c, u)
            ref = sm.stencil_matvec_2d_plain(c, u)
            torch.cuda.synchronize()
            ea, er = rel_err(got, ref)
            worst = max(worst, ea)
            check(er <= REL_TOL and got.dtype == dt,
                  f"K9 {name} {nx}x{ny} within {REL_TOL:g} (rel {er:.2e})")
            if (nx, ny) != (NX, NY):
                continue
            b_ms, b_by = bound(nbytes(c, u, got), 2 * nd * nd * 9 * nx * ny,
                               F32_FLOP_S if dt == torch.float32
                               else F64_FLOP_S)
            flush = l2_flush(dev)
            forms[name] = dict(
                flushed_times(lambda: sm.stencil_matvec_2d(c, u), flush),
                max_abs_err=ea,
                plain_ms=cuda_ms(lambda: sm.stencil_matvec_2d_plain(c, u),
                                 10),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=library_matvec_ms(c, (ny, nx), u, dtype=dt))
            del flush
            f = forms[name]
            log(f"K9 {name} {NX}x{NY}: rel {er:.2e}; kernel {f['ms']:.4f} ms "
                f"(device {fms(f['device_ms'])}; L2 flushed before each "
                f"call; back to back {f['l2_warm_ms']:.4f}, device "
                f"{fms(f['l2_warm_device_ms'])}), "
                f"plain {f['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"torch.sparse.mm ({str(dt)[6:]} CSR) {f['library_ms']:.4f} "
                f"ms")
    res = dict(forms["nd1_f32"], max_abs_err=worst, forms=forms)
    return {"K9": res}


def phase_kernels_sym2d(dev):
    """Phase 3e: K1-sym and K2-sym (half-symmetric 2D storage) against
    their plain versions at 1025x513, 17x9 and 13x7, nd=2 and nd=1: K1-sym
    with times and bounds at full size (nd=2); K2-sym in every call form
    (:func:`k2_level_rows`: one launch a call, a repeat call
    bit-identical), timed at 1025x513 nd=2 with the CSR matvec time; then
    bench 2D sym's V-cycle calls on every coarser level
    (:func:`k2_coarse_levels`)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    rng = np.random.default_rng(SEED + 10)
    res = {"K1-sym": dict(max_abs_err=0.0)}
    k2_abs = 0.0
    for nx, ny in ((NX, NY), (17, 9), (13, 7)):
        for nd in (2, 1):
            full = (nx, ny) == (NX, NY) and nd == 2
            tag = f"{nx}x{ny} nd={nd}"
            a = multigrid.GMGAssembler(
                nx, ny, (nx - 1) / (ny - 1), 1.0,
                "elasticity" if nd == 2 else "poisson", p=3.0, device=dev,
                sym=True)
            st = a.static_levels[0]
            rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                                  dtype=torch.float32, device=dev)
            args = (rho, st.maskf, st.W, a.N)
            kw = dict(nd=nd, p=3.0, lp_dtype=torch.bfloat16, sym=True)
            ck, dk, lk = fa.assemble_pack_2d(*args, **kw)
            cp, dp, _ = fa.assemble_pack_2d_plain(*args, **kw)
            torch.cuda.synchronize()
            free = st.maskf > 0
            ea, er = rel_err(ck, cp)
            ia, ir = rel_err(dk, dp, free)
            res["K1-sym"]["max_abs_err"] = max(res["K1-sym"]["max_abs_err"],
                                               ea, ia)
            check(ck.shape[0] == len(fs.sym_planes_2d(nd)) and er <= REL_TOL
                  and ir <= REL_TOL and bool((dk[~free] == 0).all())
                  and torch.equal(lk, ck.to(torch.bfloat16)),
                  f"K1-sym {tag}: {ck.shape[0]} planes within {REL_TOL:g} "
                  f"(rel {er:.2e}), inv_diag (rel {ir:.2e}), bf16 copy")
            if full:
                b_ms, b_by = bound(
                    nbytes(rho, st.maskf, st.W, a.N, ck, dk, lk),
                    k1_flops(nd, True, rho.numel()))
                res["K1-sym"].update(
                    ms=cuda_ms(lambda: fa.assemble_pack_2d(*args, **kw), 50),
                    device_ms=device_ms(
                        lambda: fa.assemble_pack_2d(*args, **kw)),
                    plain_ms=cuda_ms(
                        lambda: fa.assemble_pack_2d_plain(*args, **kw), 10),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
                r = res["K1-sym"]
                log(f"K1-sym {tag}: kernel {r['ms']:.4f} ms (device "
                    f"{fms(r['device_ms'])}), plain "
                    f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            field = lambda: torch.as_tensor(
                rng.standard_normal((nd, ny, nx)), dtype=torch.float32,
                device=dev)
            b = torch.where(st.mask, 0.0, field())
            x0 = torch.where(st.mask, 0.0, field())
            rows, _w = k2_level_rows(
                ck, dk, lk, b, x0, field(), tag,
                (lambda run: dict(ms=cuda_ms(run, 50),
                                  device_ms=device_ms(run))) if full
                else None)
            k2_abs = max([k2_abs] + [v["max_abs_err"] for v in rows.values()])
            if full:
                forms = rows
    _levels, _w, coarse_abs = k2_coarse_levels(dev, rng, sym=True)
    head = forms["presmooth_resid_bf16"]
    res["K2-sym"] = dict(max_abs_err=max(k2_abs, coarse_abs),
                         ms=head["ms"], device_ms=head["device_ms"],
                         plain_ms=head["plain_ms"],
                         bound_ms=head["bound_ms"], bound_by=head["bound_by"],
                         library_ms=None, forms=forms)
    return res


def short_ptxas(build_log, kernel):
    """ptxas's registers and spills of each instance of ``kernel``, keyed
    by its template arguments (mangled)."""
    out = {}
    for k, v in ptxas_table(build_log).items():
        if kernel + "I" in k:
            out[k.split(kernel, 1)[1].split("EEv", 1)[0] + "E"] = v
    return out


def phase_kernels_3d(dev, build_log):
    """Phase 3a: K3, K4 and K5 against their plain versions on the card,
    in half-symmetric (``sym``) and full coefficient storage; then the
    stencil pass on every level of bench 3D (``pass_levels``) and
    ptxas's registers of its kernel."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    rng = np.random.default_rng(SEED + 10)
    res = {}
    fine = {}
    for (nx, ny, nz), physics, sym in itertools.product(
        ((N3, N3, N3), (9, 7, 5)), ("elasticity", "poisson"), (True, False)
    ):
        a = multigrid.GMGAssembler3D(nx, ny, nz, (nx - 1) / (ny - 1), 1.0,
                                     (nz - 1) / (ny - 1), physics, p=3.0,
                                     device=dev)
        st, nd = a.static_levels[0], a.nd
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (nz, ny, nx)),
                              dtype=torch.float32, device=dev)
        args = (rho, st.maskf, st.W, a.N)
        kw = dict(nd=nd, p=3.0, lp_dtype=torch.bfloat16, sym=sym)
        ck, dk, lk = fa.assemble_pack_3d(*args, **kw)
        cp, dp, _ = fa.assemble_pack_3d_plain(*args, **kw)
        torch.cuda.synchronize()
        free = st.maskf > 0
        ea, er = rel_err(ck, cp)
        ia, ir = rel_err(dk, dp, free)
        form = "sym" if sym else "full"
        tag = f"K3 {form} {nx}x{ny}x{nz} nd={nd}"
        log(f"{tag}: {ck.shape[0]} planes rel {er:.2e} (abs {ea:.2e}), "
            f"inv_diag free rel {ir:.2e}")
        check(er <= REL_TOL, f"{tag} planes within {REL_TOL:g}")
        check(ir <= REL_TOL, f"{tag} inv_diag within {REL_TOL:g}")
        check(bool((dk[~free] == 0).all()), f"{tag} inv_diag 0 fixed")
        check(torch.equal(lk, ck.to(torch.bfloat16)),
              f"{tag} bf16 copy == its f32 planes rounded")
        if (nx, ny, nz, nd) == (N3, N3, N3, 3):
            b_ms, b_by = bound(nbytes(rho, st.maskf, st.W, a.N, ck, dk, lk),
                               k3_flops(nd, sym, rho.numel()))
            r = dict(
                max_abs_err=max(ea, ia),
                ms=cuda_ms(lambda: fa.assemble_pack_3d(*args, **kw), 20),
                device_ms=device_ms(lambda: fa.assemble_pack_3d(*args, **kw)),
                plain_ms=cuda_ms(lambda: fa.assemble_pack_3d_plain(
                    *args, **kw), 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
            log(f"K3 {form} {N3}^3: kernel {r['ms']:.4f} ms (device "
                f"{fms(r['device_ms'])}), plain "
                f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
            res["K3" if sym else "K3 full"] = r
            fine[form] = (ck, dk, lk, st.mask)

    mask = fine["sym"][3]
    shape = (3, N3, N3, N3)
    field = lambda: torch.as_tensor(rng.standard_normal(shape),
                                    dtype=torch.float32, device=dev)
    b = torch.where(mask, 0.0, field())
    x0 = torch.where(mask, 0.0, field())
    xr = field()
    n3 = N3 ** 3
    k4 = {}
    for form, (ck, dk, lk, _m) in fine.items():
        for cname, c in (("f32", ck), ("bf16", lk)):
            pre = f"{form}_{cname}"
            k4.update({
                f"sweep_{pre}": ((c, dk, b, x0), dict(mode="sweep",
                                                      omega=0.5)),
                f"resid_{pre}": ((c, None, b, x0), dict(mode="resid")),
                f"negresid_{pre}": ((c, None, b, x0),
                                    dict(mode="resid", neg_resid=True)),
                f"matvec_{pre}": ((c, None, None, xr),
                                  dict(mode="matvec", neg_resid=True)),
                f"negmatvec_{pre}": ((c, None, None, xr),
                                     dict(mode="matvec")),
            })
    worst = 0.0
    for name, (a, kw) in k4.items():
        got = fs.fused_sweep_3d(*a, **kw)
        ref = fs.fused_sweep_3d_plain(*a, **kw)
        torch.cuda.synchronize()
        ea, er = rel_err(got, ref)
        worst = max(worst, ea)
        log(f"K4 {name}: rel {er:.2e}")
        check(er <= REL_TOL, f"K4 {name} within {REL_TOL:g}")
    lib = library_matvec_ms(fs.full_planes_3d(fine["sym"][0], 3),
                            (N3, N3, N3), xr)
    for form in ("sym", "full"):
        a, kw = k4[f"matvec_{form}_f32"]
        ck = fine[form][0]
        # per node: one FMA per plane and neighbour: 243 either way
        b_ms, b_by = bound(nbytes(ck, xr) + nbytes(xr), 2 * 243 * n3)
        r = dict(
            max_abs_err=worst,
            ms=cuda_ms(lambda: fs.fused_sweep_3d(*a, **kw), 50),
            device_ms=device_ms(lambda: fs.fused_sweep_3d(*a, **kw)),
            plain_ms=cuda_ms(lambda: fs.fused_sweep_3d_plain(*a, **kw), 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib)
        res["K4" if form == "sym" else "K4 full"] = r
        log(f"K4 matvec_{form}_f32 {N3}^3: kernel {r['ms']:.4f} ms (device "
            f"{fms(r['device_ms'])}), plain "
            f"{r['plain_ms']:.4f} ms, torch.sparse.mm (f32 CSR) "
            f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # one sweep pass on f32 and on bf16 planes, device time: what bounds
    # the pass (bytes halve in bf16)
    a32, kw32 = k4["sweep_sym_f32"]
    a16, kw16 = k4["sweep_sym_bf16"]
    d = [device_ms(lambda: fs.fused_sweep_3d(*a, **kw))
         for a, kw in ((a32, kw32), (a16, kw16))]
    log(f"K4 sweep pass {N3}^3, device time (profiler): f32 planes "
        f"{fms(d[0])} ms, bf16 planes {fms(d[1])} ms")
    res["K4"]["sweep_device_ms"] = dict(f32=d[0], bf16=d[1])

    ck, dk, lk, _m = fine["sym"]
    om2 = multigrid.smoothing_omegas(2, 3.0)
    k5 = {
        "presmooth_resid_bf16": ((lk, dk, b, None),
                                 dict(niter=2, want_resid=True, omega=om2)),
        "postsmooth_bf16": ((lk, dk, b, x0), dict(niter=2, omega=om2[::-1])),
        "full_presmooth_resid_bf16": ((fine["full"][2], fine["full"][1], b,
                                       None),
                                      dict(niter=2, want_resid=True,
                                           omega=om2)),
    }
    worst = 0.0
    for name, (a, kw) in k5.items():
        got = fs.fused_sweeps3d(*a, **kw)
        ref = fs.fused_sweeps3d_plain(*a, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        worst = max([worst] + [e[0] for e in errs])
        ms = cuda_ms(lambda: fs.fused_sweeps3d(*a, **kw), 20)
        pms = cuda_ms(lambda: fs.fused_sweeps3d_plain(*a, **kw), 3)
        log(f"K5 {name}: rel " + ", ".join(f"{e[1]:.2e}" for e in errs)
            + f"; kernel {ms:.4f} ms, plain {pms:.4f} ms")
        check(all(e[1] <= REL_TOL for e in errs),
              f"K5 {name} within {REL_TOL:g}")
        if name == "presmooth_resid_bf16":
            # the function reads the planes once; the per-sweep form
            # reads them halo_sweeps_3d(2, True, True) = 2 times
            b_ms, b_by = bound(nbytes(lk, dk, b) + 2 * nbytes(b),
                               2 * 243 * 2 * n3)
            dms = device_ms(lambda: fs.fused_sweeps3d(*a, **kw))
            res["K5"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                             bound_by=b_by, library_ms=None, device_ms=dms)
            log(f"K5 {name}: bound {b_ms:.4f} ms ({b_by}); stencil "
                f"passes {fs.halo_sweeps_3d(2, True, True)}; device time "
                f"(profiler) {fms(dms)} ms")
    # nu=4 Chebyshev-node sweeps: the residual is damped below b, so its
    # rounding is measured against max|b| (as K2's niter=8 check)
    kw = dict(niter=4, want_resid=True,
              omega=multigrid.smoothing_omegas(4, 3.0))
    (xk, rk), (xp, rp) = (fs.fused_sweeps3d(lk, dk, b, x0, **kw),
                          fs.fused_sweeps3d_plain(lk, dk, b, x0, **kw))
    ex, rr = rel_err(xk, xp), rel_err(rk, rp)
    bmax = float(b.abs().max())
    log(f"K5 nu4_cheby_bf16: x rel {ex[1]:.2e}; r rel {rr[1]:.2e} of "
        f"max|r|, {rr[0] / bmax:.2e} of max|b|")
    check(ex[1] <= REL_TOL and rr[0] <= REL_TOL * bmax,
          f"K5 nu4_cheby x and r within {REL_TOL:g} (r of max|b|)")
    res["K5"]["max_abs_err"] = max(worst, ex[0], rr[0])
    times, _w = pass_levels(dev)
    PASS_TIMES.update(times)
    for n in PASS_LEVELS:
        t = times[n]
        log(f"3D stencil pass {n}^3, device time (profiler): sweep on bf16 "
            f"sym planes {fms(t['sweep_sym_bf16'])} ms, f32 sym "
            f"{fms(t['sweep_sym_f32'])}, bf16 full {fms(t['sweep_full_bf16'])}; "
            f"f32 sym matvec {fms(t['matvec_sym_f32'])}; K5 bf16 "
            f"presmooth+resid {fms(t['k5_presmooth_resid_bf16'])} ms")
    k3regs = short_ptxas(build_log, "assemble_3d_kernel")
    log(f"ptxas assemble_3d_kernel: {k3regs}")
    res["K3"]["ptxas"] = k3regs
    regs = short_ptxas(build_log, "sweep_3d_kernel")
    log(f"ptxas sweep_3d_kernel: {regs}")
    levels = {n: {k: v for k, v in times[n].items() if not k.startswith("k6")}
              for n in PASS_LEVELS}
    res["K4"].update(levels_device_ms=levels, ptxas=regs)
    res["K5"]["levels_device_ms"] = {
        n: times[n]["k5_presmooth_resid_bf16"] for n in PASS_LEVELS}
    return res


def k3_flops(nd, sym, nnodes):
    """float32 operations K3 needs: per node one multiply-add per
    structurally nonzero weight of its stored planes (512 per (a, b)
    block in full storage: an element must hold both nodes; in half
    storage those of the kept planes), and per element (about one per
    node) 64 for the materials at its 8 points."""
    from pyfem_gpu_testflight_tpu_torch.ops.fused_smooth import sym_planes_3d

    planes = ([(dz, dy, dx) for (_k, _a, _b, dz, dy, dx, _s)
               in sym_planes_3d(nd)] if sym else
              [(d // 9, d // 3 % 3, d % 3) for d in range(27)] * nd * nd)
    w = sum(8 * (2 if dz == 1 else 1) * (2 if dy == 1 else 1)
            * (2 if dx == 1 else 1) for dz, dy, dx in planes)
    return 2 * (w + 64) * nnodes


def k1_flops(nd, sym, nnodes):
    """float32 operations K1 needs: per node one multiply-add per
    structurally nonzero weight of its stored planes (64 per (a, b) block
    in full storage: an element must hold both nodes; in half storage
    those of the kept planes), and per element (about one per node) 16
    for the materials at its 4 points."""
    from pyfem_gpu_testflight_tpu_torch.ops.fused_smooth import sym_planes_2d

    planes = ([(dy, dx) for (_k, _a, _b, dy, dx, _s) in sym_planes_2d(nd)]
              if sym else [divmod(d, 3) for d in range(9)] * nd * nd)
    w = sum(4 * (2 if dy == 1 else 1) * (2 if dx == 1 else 1)
            for dy, dx in planes)
    return 2 * (w + 16) * nnodes


# bench 3D's levels with K3: 65^3 down to the coarsest, 3^3
ASSEMBLY_LEVELS = (65, 33, 17, 9, 5, 3)


def k1_levels(dev, rng):
    """K1 on every level of bench 2D (1025x513 down to 9x5), in full and
    half storage at nd 2 (elasticity) and 1 (Poisson), with the bf16 copy
    as bench 2D asks for it: each held against its plain version (planes,
    free inverse diagonal and 0 at fixed dofs, the bf16 copy equal to its
    planes rounded, a repeat call bit-identical) and timed by device time.
    Returns ({"nx x ny": {form: ms}}, {"K1 form nx": (bound_ms,
    bound_by)}, worst error relative to max|plain|)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    times, bounds, worst = {}, {}, 0.0
    for physics in ("elasticity", "poisson"):
        a = multigrid.GMGAssembler(NX, NY, 2.0, 1.0, physics, p=3.0,
                                   device=dev, min_n=5)
        for st in a.static_levels:
            ny, nx = st.shape
            rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                                  dtype=torch.float32, device=dev)
            args = (rho, st.maskf, st.W, a.N)
            lvl = times.setdefault(f"{nx}x{ny}", {})
            for sym in (False, True):
                kw = dict(nd=a.nd, p=3.0, lp_dtype=torch.bfloat16, sym=sym)
                got = fa.assemble_pack_2d(*args, **kw)
                ref = fa.assemble_pack_2d_plain(*args, **kw)
                again = fa.assemble_pack_2d(*args, **kw)
                torch.cuda.synchronize()
                form = f"{'sym' if sym else 'full'} nd={a.nd}"
                free = st.maskf > 0
                worst = max(worst, rel_err(got[0], ref[0])[1],
                            rel_err(got[1], ref[1], free)[1])
                check(torch.equal(got[2], got[0].to(torch.bfloat16))
                      and bool((got[1][~free] == 0).all())
                      and all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"K1 {form} {nx}x{ny}: bf16 copy == its f32 planes "
                      f"rounded, inv_diag 0 fixed, repeat call "
                      f"bit-identical")
                bounds[f"K1 {form} {nx}"] = bound(
                    nbytes(*args, *got), k1_flops(a.nd, sym, rho.numel()))
                del got, ref, again
                lvl[form] = device_ms(lambda: fa.assemble_pack_2d(*args, **kw))
    return times, bounds, worst


def assembly_kernels(dev):
    """Device time per call (``torch.profiler``, the median of three
    sessions of 20 calls) of K1 on every level of bench 2D in full and
    half storage at nd 2 and 1 (``k1_levels``), and of bench 2D's and
    bench 2D sym's assemble+solve (median of three sessions of 5); of K3
    on every level of bench 3D in half and
    full storage at nd 3 (elasticity) and 1 (Poisson), with the bf16
    copy as bench 3D asks for it; of every K8 form on phase 3c's inputs
    (hex8 at 65^3, tet10 and brick20 on the 33^3 lattice, jittered); and
    of ``element_jacobian(kernel="cuda")`` on 5c's model (K8 and the
    layout the operator reads), with its CUDA-event time.  Each kernel
    is held against its plain version (planes and free inverse diagonal,
    the bf16 copy equal to its planes rounded).  Uses only the package's
    public functions, so ``--assembly-kernels --root DIR`` times a
    parent checkout on the same inputs.  Returns ({"K1": {"nx x ny":
    {form: ms}}, "bench_2d_device_ms": {...}, "K3": {n: {form: ms}},
    "K8": {form: ms}, "element_jacobian_5c": {...}, "bound_ms": {...}},
    worst error relative to max|plain|)."""
    import torch
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )

    rng = np.random.default_rng(SEED + 50)
    out = {"K3": {}, "K8": {}, "bound_ms": {}}
    out["K1"], out["bound_ms"], worst = k1_levels(dev, rng)
    out["bench_2d_device_ms"] = {}
    for label, route in (("bench 2D", {}), ("bench 2D sym", {"sym": True})):
        _m, _a, rho, rhs, step, _L = bench2d(dev, pt, multigrid, i2p, p2i,
                                             **route)
        k = step(rho, rhs, rhs)[1]
        out["bench_2d_device_ms"][label] = dict(
            iterations=int(k), device_ms=device_ms(lambda: step(rho, rhs, rhs),
                                              reps=5))
        del step
    for n in ASSEMBLY_LEVELS:
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (n, n, n)),
                              dtype=torch.float32, device=dev)
        out["K3"][n] = {}
        for physics in ("elasticity", "poisson"):
            a = multigrid.GMGAssembler3D(n, n, n, 1.0, 1.0, 1.0, physics,
                                         p=3.0, device=dev)
            st = a.static_levels[0]
            args = (rho, st.maskf, st.W, a.N)
            for sym in (True, False):
                kw = dict(nd=a.nd, p=3.0, lp_dtype=torch.bfloat16, sym=sym)
                got = fa.assemble_pack_3d(*args, **kw)
                ref = fa.assemble_pack_3d_plain(*args, **kw)
                torch.cuda.synchronize()
                form = f"{'sym' if sym else 'full'} nd={a.nd}"
                worst = max(worst, rel_err(got[0], ref[0])[1],
                            rel_err(got[1], ref[1], st.maskf > 0)[1])
                check(torch.equal(got[2], got[0].to(torch.bfloat16)),
                      f"K3 {form} {n}^3: bf16 copy == its f32 planes "
                      f"rounded")
                out["bound_ms"][f"K3 {form} {n}"] = bound(
                    nbytes(*args, *got), k3_flops(a.nd, sym, rho.numel()))
                del got, ref
                out["K3"][n][form] = device_ms(
                    lambda: fa.assemble_pack_3d(*args, **kw))
    models = {}
    for key, etype, ctype, _tag in ELEM_FORMS:
        if not key.startswith("K8 "):
            continue
        physics = "poisson" if "poisson" in key else "elasticity"
        if etype not in models:
            dims = (N3,) * 3 if etype == "hex8" else (33,) * 3
            conn, X, fixed, force = elem_problem(dims, ctype, SEED + 30)
            m = pt.LinearElasticity(etype, X, conn, fixed, None, force,
                                    p=3.0, dtype=torch.float32, device=dev,
                                    kernel="cuda")
            models[etype] = (m, torch.as_tensor(
                density(etype, X, SEED + 31), dtype=torch.float32,
                device=dev))
        m, rho = models[etype]
        fk, fp, (XeT, cqT) = stiffness_pair(m, etype, physics, rho)
        got, ref = fk(), fp()
        torch.cuda.synchronize()
        worst = max(worst, rel_err(got, ref)[1])
        check(torch.equal(got, fk()), f"{key}: repeat call bit-identical")
        et = pt.get_element(etype)
        out["bound_ms"][key] = bound(nbytes(XeT, cqT, got), stiffness_flops(
            et.nnodes, et.nquads, et.ndims if physics == "elasticity" else 1,
            et.ndims, m.nelems))
        del got, ref
        out["K8"][key[3:]] = device_ms(fk)
    del models
    mesh = elem_problem((N3,) * 3, "block", SEED + 40)
    rho = np.random.default_rng(SEED + 41).uniform(0.3, 1.0, len(mesh[1]))
    m = make_model(pt, "elasticity", "hex8", mesh, torch.float32, "cuda",
                   dev)
    ej = lambda: m.element_jacobian(rho)  # noqa: E731
    out["element_jacobian_5c"] = dict(ms=cuda_ms(ej, 5),
                                      device_ms=device_ms(ej, reps=5))
    check(worst <= REL_TOL, f"K1, K3 and K8 within {REL_TOL:g} of "
          f"max|plain| (worst {worst:.2e})")
    return out, worst


def run_assembly_kernels():
    """``python3 chip_smoke.py --assembly-kernels [--root DIR]``: only
    :func:`assembly_kernels`, on the package under DIR (default: this
    checkout); prints the card and one JSON line with ptxas's registers
    and spills of K1's, K3's and K8's instances."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--root" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    out, worst = assembly_kernels(torch.device("cuda", 0))
    out["ptxas"] = {k: short_ptxas(_cuda.build_log, k)
                    for k in ("assemble_2d_kernel", "assemble_2d_tiles",
                              "assemble_3d_kernel", "stiffness_3d_kernel",
                              "poisson_elem_kernel")}
    log(json.dumps({"package": pt.__file__, "worst_rel_err": worst, **out}))
    return 1 if FAILS else 0


# K2 entry points: the one-pass call (pyfem_sweeps_2d) and the single
# stencil step (pyfem_smooth_2d) on full storage, and their K2-sym
# counterparts on half storage; a parent checkout may lack a one-pass
# entry, so counts read each with a default of 0
K2_ENTRIES = ("pyfem_smooth_2d", "pyfem_sweeps_2d")
K2_SYM_ENTRIES = ("pyfem_smooth_2d_sym", "pyfem_sweeps_2d_sym")


def k2_launches(launches, entries=K2_ENTRIES):
    return sum(launches.get(k, 0) for k in entries)


def k2_sym_launches(launches):
    return k2_launches(launches, K2_SYM_ENTRIES)


def l2_flush_clean(dev):
    """A callable that evicts the card's L2 cache by READING a 1 GiB
    buffer (a sum), so that the call timed after it finds the L2 full of
    clean lines.  :func:`l2_flush` writes its buffer, which leaves up to
    50 MB of dirty lines that the timed call's misses then write back to
    device memory inside its own timed span; this flush does not.  Its
    ``floor_ms`` is 90% of the read's time at the card's memory rate."""
    import torch

    buf = torch.ones(256 << 20, dtype=torch.float32, device=dev)

    def flush():
        buf.sum()

    flush.floor_ms = 0.9e3 * nbytes(buf) / HBM_BYTES_S
    return flush


def stencil_times(run, flush, flush_clean, reps=50):
    """:func:`flushed_times` with the L2 flushed by a write (``ms``,
    ``device_ms``), by a read (``clean_ms``, ``clean_device_ms``) and
    back to back (``l2_warm_ms``, ``l2_warm_device_ms``)."""
    return dict(flushed_times(run, flush, reps),
                clean_ms=cuda_ms(run, reps, between=flush_clean),
                clean_device_ms=device_ms(run, between=flush_clean))


def k2_call_forms(ck, dk, lk, b, x0, xr):
    """The K2 call forms the main paths run, each as one
    ``fused_sweeps_2d`` call: bench 2D's V-cycle (bf16 presmooth with its
    residual, bf16 postsmooth, the fine level's f32 postsmooth with the
    PCG's residual), newton's (f32 presmooth with its residual, f32
    postsmooth), the PCG matvec and the Chebyshev smoother's residual
    pass; and, untimed, 8 sweeps with the residual, Chebyshev-node and
    constant damping (two sweep groups on the card)."""
    from pyfem_gpu_testflight_tpu_torch import multigrid

    om2 = multigrid.smoothing_omegas(2, 2.3)
    return {
        "presmooth_resid_bf16": ((lk, dk, b, None),
                                 dict(niter=2, want_resid=True, omega=om2)),
        "postsmooth_bf16": ((lk, dk, b, x0), dict(niter=2, omega=om2[::-1])),
        "presmooth_resid_f32": ((ck, dk, b, None),
                                dict(niter=2, want_resid=True, omega=om2)),
        "postsmooth_f32": ((ck, dk, b, x0), dict(niter=2, omega=om2[::-1])),
        "postsmooth_resid_f32": ((ck, dk, b, x0),
                                 dict(niter=2, want_resid=True,
                                      omega=om2[::-1])),
        "matvec_f32": ((ck, dk, None, xr),
                       dict(niter=0, want_resid=True, neg_resid=True)),
        "cheb_resid_bf16": ((lk, dk, b, x0), dict(niter=0, want_resid=True)),
        "niter8_cheby_f32": ((ck, dk, b, None), dict(
            niter=8, want_resid=True,
            omega=multigrid.smoothing_omegas(8, 2.3))),
        "niter8_f32": ((ck, dk, b, None), dict(niter=8, want_resid=True,
                                               omega=0.7)),
    }


def k2_call_bound(args, kw, out):
    """One pass of a K2 call: the planes once, each input field once,
    each output once; the operations of its stencil steps."""
    coeff, invd, b, x = args
    nd, ny, nx = invd.shape
    steps = (kw["niter"] - (1 if x is None else 0)
             + (1 if kw.get("want_resid") else 0))
    return bound(nbytes(coeff, invd, b, x, *out),
                 2 * 9 * nd * nd * ny * nx * steps)


def k2_levels(dev, rng, nx, ny, nd, sym=False):
    """K1's planes of one level (p = 3, seeded density; K1-sym's kept
    planes with ``sym``) and its fields: (ck, dk, lk, b, x0, xr)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa

    a = multigrid.GMGAssembler(nx, ny, (nx - 1) / (ny - 1), 1.0,
                               "elasticity" if nd == 2 else "poisson",
                               p=3.0, device=dev, min_n=nx + ny)
    st = a.static_levels[0]
    rho = torch.as_tensor(rng.uniform(0.2, 1.0, (ny, nx)),
                          dtype=torch.float32, device=dev)
    ck, dk, lk = fa.assemble_pack_2d(rho, st.maskf, st.W, a.N, nd=nd, p=3.0,
                                     lp_dtype=torch.bfloat16, sym=sym)
    field = lambda: torch.as_tensor(rng.standard_normal((nd, ny, nx)),
                                    dtype=torch.float32, device=dev)
    return (ck, dk, lk, torch.where(st.mask, 0.0, field()),
            torch.where(st.mask, 0.0, field()), field())


def k2_level_rows(ck, dk, lk, b, x0, xr, size, times=None, forms=None):
    """K2 call forms (:func:`k2_call_forms`, those named in ``forms`` or
    all) on one level, on full storage or (K2-sym) the kept planes: error
    against the plain version, relative to max|plain| (the residual after
    8 Chebyshev-node sweeps, damped far below b, of max|b|, the scale it
    is computed at), a repeat call bit-identical, launches per call (one
    up to the sweep budget; a package without the storage's one-pass
    entry, a parent checkout, one a stencil step) and, with ``times``,
    ``times(run)`` for the forms but the 8-sweep ones, the one-pass
    bound, the plain version's time and, for the matvec,
    ``torch.sparse.mm``'s.  Returns ({form: row}, worst relative
    error)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    nd, ny, nx = dk.shape
    sym = not fs.is_full_storage_2d(ck, nd)
    label, entries = ("K2-sym", K2_SYM_ENTRIES) if sym else ("K2", K2_ENTRIES)
    one_pass = entries[1] in _cuda.launches
    rows, worst = {}, 0.0
    tup = lambda v: v if isinstance(v, tuple) else (v,)
    for name, (a, kw) in k2_call_forms(ck, dk, lk, b, x0, xr).items():
        if forms is not None and name not in forms:
            continue
        n0 = dict(_cuda.launches)
        got = tup(fs.fused_sweeps_2d(*a, **kw))
        torch.cuda.synchronize()
        nl = k2_launches(_cuda.launches, entries) - k2_launches(n0, entries)
        ref = tup(fs.fused_sweeps_2d_plain(*a, **kw))
        again = tup(fs.fused_sweeps_2d(*a, **kw))
        scale = [float(r.abs().max()) for r in ref]
        if name == "niter8_cheby_f32":
            scale[-1] = float(b.abs().max())
        errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
        rel = max(e / s for e, s in zip(errs, scale))
        worst = max(worst, rel)
        check(rel <= REL_TOL, f"{label} {name} {size} within {REL_TOL:g} "
              f"(rel {rel:.2e})")
        check(all(torch.equal(g, h) for g, h in zip(got, again)),
              f"{label} {name} {size}: repeat call bit-identical")
        steps = (kw["niter"] - (a[3] is None)
                 + kw.get("want_resid", False))
        want = (1 if kw["niter"] == 0 else
                max(1, -(-steps // fs.SWEEP_BUDGET_2D)) if one_pass else
                kw["niter"] + kw.get("want_resid", False))
        check(nl == want, f"{label} {name} {size}: {want} launch(es) a "
              f"call ({nl})")
        row = dict(max_abs_err=max(errs), rel_err=rel, launches=nl)
        del again
        if times is not None and not name.startswith("niter8"):
            run = lambda: fs.fused_sweeps_2d(*a, **kw)
            b_ms, b_by = k2_call_bound(a, kw, got)
            row.update(times(run), plain_ms=cuda_ms(
                lambda: fs.fused_sweeps_2d_plain(*a, **kw), 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=(
                    library_matvec_ms(fs.as_full_planes_2d(a[0], nd),
                                      (ny, nx), xr)
                    if name == "matvec_f32" else None))
            log(f"{label} {name} {size}: rel {rel:.2e}, {nl} launch(es); "
                + ", ".join(f"{k} {fms(v)}" for k, v in row.items()
                            if k.endswith("ms")
                            and not (k == "library_ms" and v is None))
                + f" ({b_by})")
        rows[name] = row
        del got, ref
    return rows, worst


def k2_call_rows(dev, rng, flush, flush_clean, sym=False):
    """Every K2 call form (:func:`k2_level_rows`; K2-sym's with ``sym``)
    at 1025x513 nd=2 (bench 2D's fine level) and at 1025^2 nd=1
    (newton's size), timed by :func:`stencil_times`."""
    rows, worst = {}, 0.0
    for nx, ny, nd in ((NX, NY, 2), (NEWTON_N, NEWTON_N, 1)):
        size = f"{nx}x{ny} nd={nd}"
        r, w = k2_level_rows(*k2_levels(dev, rng, nx, ny, nd, sym), size,
                             lambda run: stencil_times(run, flush,
                                                       flush_clean))
        rows.update({f"{k} {size}": v for k, v in r.items()})
        worst = max(worst, w)
    return rows, worst


def k9_form_rows(dev, pt, rng, flush, flush_clean):
    """Every K9 form: nd=1 (the Helmholtz filter's planes) and nd=2 (the
    float64 accuracy operator's elasticity planes) in f32 and f64 at
    1025x513, and newton's nonsymmetric tangent planes (f32) and its
    flux planes (f64) at 1025^2 on a seeded iterate: error against the
    plain version, a repeat call bit-identical, launches, times
    (:func:`stencil_times`), bound, plain and ``torch.sparse.mm`` times."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    conn, X, _f, _l, (Lx, Ly) = problem(NX, NY)
    filt = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float64,
                        device=dev).attach_structured_grid(NX, NY)
    rho = torch.as_tensor(rng.uniform(0.3, 1.0, NX * NY), device=dev)
    c2 = f64_operator(NX, NY, Lx, Ly, rho, 3.0, dev)[2]
    n = NEWTON_N
    model = newton_model(pt, dev, n, torch.float32)
    mask0 = model._gmg_newton.static_levels[0].mask
    xdv = torch.full((10,), 0.1, dtype=torch.float32, device=dev)
    u = torch.as_tensor(rng.uniform(0.0, 0.5, (n, n)), dtype=torch.float32,
                        device=dev)
    cs, cr = model._uniform_tangent_coeffs(xdv, u)
    tangent = model._gmg_newton.static_levels[0].op.bc_eliminate(cs + cr,
                                                                 mask0)
    forms = {"nd1_f32": (filt._coeffK, torch.float32),
             "nd1_f64": (filt._coeffK, torch.float64),
             "nd2_f32": (c2, torch.float32), "nd2_f64": (c2, torch.float64),
             "newton_tangent_f32": (tangent, torch.float32),
             "newton_flux_f64": (cs, torch.float64)}
    rows, worst = {}, 0.0
    for name, (c, dt) in forms.items():
        c = c.to(dt).contiguous()
        nd, ny, nx = c.shape[0], c.shape[-2], c.shape[-1]
        v = torch.as_tensor(rng.standard_normal((nd, ny, nx)), dtype=dt,
                            device=dev)
        n0 = _cuda.launches["pyfem_stencil_2d"]
        got = sm.stencil_matvec_2d(c, v)
        torch.cuda.synchronize()
        nl = _cuda.launches["pyfem_stencil_2d"] - n0
        ref = sm.stencil_matvec_2d_plain(c, v)
        ea, er = rel_err(got, ref)
        worst = max(worst, er)
        check(er <= REL_TOL and got.dtype == dt,
              f"K9 {name} {nx}x{ny} within {REL_TOL:g} (rel {er:.2e})")
        check(torch.equal(got, sm.stencil_matvec_2d(c, v)),
              f"K9 {name} {nx}x{ny}: repeat call bit-identical")
        run = lambda: sm.stencil_matvec_2d(c, v)
        b_ms, b_by = bound(nbytes(c, v, got), 2 * nd * nd * 9 * nx * ny,
                           F32_FLOP_S if dt == torch.float32 else F64_FLOP_S)
        row = dict(stencil_times(run, flush, flush_clean), max_abs_err=ea,
                   rel_err=er, launches=nl,
                   plain_ms=cuda_ms(lambda: sm.stencil_matvec_2d_plain(c, v),
                                    10),
                   bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_matvec_ms(c, (ny, nx), v, dtype=dt))
        log(f"K9 {name} {nx}x{ny}: rel {er:.2e}; events {row['ms']:.4f} ms "
            f"(write flush) / {row['clean_ms']:.4f} (read flush) / "
            f"{row['l2_warm_ms']:.4f} (back to back); device "
            f"{fms(row['device_ms'])} / {fms(row['clean_device_ms'])} / "
            f"{fms(row['l2_warm_device_ms'])}; bound {b_ms:.4f} ms ({b_by}); "
            f"plain {row['plain_ms']:.4f} ms, torch.sparse.mm "
            f"{row['library_ms']:.4f} ms")
        rows[f"{name} {nx}x{ny}"] = row
        del got, ref
    return rows, worst


# the V-cycle's K2 call forms on every level of bench 2D, 4d and topo
# (bf16 planes) and the PCG's f32 postsmooth with the residual
BENCH_V_FORMS = ("presmooth_resid_bf16", "postsmooth_bf16",
                 "postsmooth_resid_f32")


def k2_coarse_levels(dev, rng, timed=False, sym=False):
    """K2's bench 2D call forms (:data:`BENCH_V_FORMS`, nd=2; K2-sym's,
    bench 2D sym's, with ``sym``) on every level of bench 2D below the
    finest, 513x257 down to 9x5: each held against the plain version
    (:func:`k2_level_rows`) and, ``timed``, its device time back to back.
    Returns ({level: rows}, worst relative error, worst absolute
    error)."""
    out, worst, worst_abs = {}, 0.0, 0.0
    for i in range(1, 8):
        nx, ny = (1024 >> i) + 1, (512 >> i) + 1
        rows, w = k2_level_rows(
            *k2_levels(dev, rng, nx, ny, 2, sym), f"{nx}x{ny} nd=2",
            times=(lambda run: dict(device_ms=device_ms(run))) if timed
            else None, forms=BENCH_V_FORMS)
        out[f"{nx}x{ny}"] = rows
        worst = max(worst, w)
        worst_abs = max([worst_abs] + [r["max_abs_err"]
                                       for r in rows.values()])
        log(f"K2{'-sym' if sym else ''} level {nx}x{ny}: " + "; ".join(
            f"{k} rel {v['rel_err']:.2e}"
            + (f", {fms(v['device_ms'])} ms" if timed else "")
            + f" ({v['launches']} launch)" for k, v in rows.items()))
    return out, worst, worst_abs


def k2_step_chain(a, kw):
    """A K2 call as the step kernel runs it: one ``pyfem_smooth_2d``
    (half storage: ``pyfem_smooth_2d_sym``) launch a sweep (from x0 = 0
    the first is elementwise) and one for the residual."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    planes, dk, b, x = a
    nd, ny, nx = dk.shape
    ptr = lambda t: None if t is None else t.data_ptr()
    entry = ("pyfem_smooth_2d" if fs.is_full_storage_2d(planes, nd)
             else "pyfem_smooth_2d_sym")

    def step(xin, om, mode):
        out = torch.empty_like(dk)
        _cuda.launch(entry, planes.data_ptr(),
                     int(planes.dtype == torch.bfloat16), dk.data_ptr(),
                     ptr(b), ptr(xin), out.data_ptr(), nd, ny, nx,
                     float(om), mode, _cuda.stream_ptr(dk))
        return out

    for om in fs._omega_seq(kw.get("omega", 0.7), kw["niter"]):
        x = step(x, om, 0)
    want = kw.get("want_resid", False)
    r = step(x, 0.0, 2 if kw.get("neg_resid") else 1) if want else None
    return fs._outputs(x, r, kw["niter"], want)


def k2_float64_witness(dev):
    """K2's and K2-sym's float32 forms against the plain version in
    float64 on the same inputs (the stored planes widened): the one-pass
    call (the wrapper), the plain version in float32 and the step-kernel
    chain (:func:`k2_step_chain`), with Chebyshev-node damping
    (``smoothing_omegas(niter, 2.3)``) at niter 1-8, from x0 = 0 with
    the residual and from x0 with the negated residual, nd 1 and 2, f32
    and bf16 planes, full and half storage, on 3x3, 13x7, 9x5, 17x9,
    33x17 and 65x33 grids with seeds 0-3, and at 1025x513 nd=2 and 1025^2
    nd=1 (seed 0).  Errors are over the card test's scale (max|plain|; a
    residual's max(|plain|, |b|)).  Returns a row per storage and niter:
    the largest error of each float32 version, the median and largest
    ratio of the one-pass call's error to the plain version's, the
    largest difference of the two float32 versions, how many calls put
    it over ``REL_TOL`` and how many equal the step chain bit for bit
    (checked: every call)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    tup = lambda v: v if isinstance(v, tuple) else (v,)
    acc = {(sym, n): dict(kernel=[], plain=[], chain=[], ratio=[], kp=[],
                          over=0, calls=0, same=0)
           for sym in (False, True) for n in range(1, 9)}
    cases = [(nx, ny, nd, seed) for nx, ny in ((3, 3), (13, 7), (9, 5),
                                              (17, 9), (33, 17), (65, 33))
             for nd in (1, 2) for seed in range(4)]
    cases += [(NX, NY, 2, 0), (NEWTON_N, NEWTON_N, 1, 0)]
    for (nx, ny, nd, seed), sym in itertools.product(cases, (False, True)):
        rng = np.random.default_rng(seed)
        ck, dk, lk, b, x0, _xr = k2_levels(dev, rng, nx, ny, nd, sym)
        w64 = lambda t: None if t is None else t.double()
        for planes in (ck, lk):
            for niter in range(1, 9):
                om = multigrid.smoothing_omegas(niter, 2.3)
                for x, neg in ((None, False), (x0, True)):
                    kw = dict(niter=niter, want_resid=True, neg_resid=neg,
                              omega=om)
                    a = (planes, dk, b, x)
                    k = tup(fs.fused_sweeps_2d(*a, **kw))
                    p = tup(fs.fused_sweeps_2d_plain(*a, **kw))
                    c = tup(k2_step_chain(a, kw))
                    e = tup(fs.fused_sweeps_2d_plain(
                        planes, w64(dk), w64(b), w64(x), **kw))
                    row = acc[sym, niter]
                    row["calls"] += 1
                    row["same"] += all(torch.equal(u, v)
                                       for u, v in zip(k, c))
                    over = False
                    for i in range(len(e)):
                        sc = float(p[i].abs().max())
                        if i == len(e) - 1:
                            sc = max(sc, float(b.abs().max()))
                        err = lambda v: float((v[i].double() - e[i])
                                              .abs().max()) / sc
                        ek, ep, ec = err(k), err(p), err(c)
                        kp = float((k[i] - p[i]).abs().max()) / sc
                        row["kernel"].append(ek)
                        row["plain"].append(ep)
                        row["chain"].append(ec)
                        row["kp"].append(kp)
                        if ep > 0:
                            row["ratio"].append(ek / ep)
                        over = over or kp > REL_TOL
                    row["over"] += over
        del ck, dk, lk, b, x0
    out = {}
    for (sym, n), row in acc.items():
        key = f"{'half' if sym else 'full'} niter {n}"
        out[key] = dict(calls=row["calls"], kernel_max=max(row["kernel"]),
                      plain_max=max(row["plain"]),
                      chain_max=max(row["chain"]),
                      ratio_median=float(np.median(row["ratio"])),
                      ratio_max=max(row["ratio"]),
                      kernel_vs_plain_max=max(row["kp"]),
                      calls_over_tol=row["over"],
                      calls_equal_to_step_chain=row["same"])
        o = out[key]
        log(f"{'K2-sym' if sym else 'K2'} float64 witness niter {n}: "
            f"{row['calls']} calls; error over the test's scale, one-pass "
            f"{o['kernel_max']:.2e}, plain f32 {o['plain_max']:.2e}, step "
            f"chain {o['chain_max']:.2e}; one-pass/plain median "
            f"{o['ratio_median']:.2f}, max {o['ratio_max']:.2f}; one-pass "
            f"vs plain {o['kernel_vs_plain_max']:.2e}, {row['over']} calls "
            f"over {REL_TOL:g}; {row['same']} calls bit-identical to the "
            f"step chain")
        check(row["same"] == row["calls"],
              f"{'K2-sym' if sym else 'K2'} niter {n}: every one-pass call "
              f"equals the step chain bit for bit ({row['same']} of "
              f"{row['calls']})")
    return out


def k2_nd1_forms(dev, flush_clean):
    """The bf16 V-cycle calls at nd=1 on a 1025^2 level (no main path
    runs them: newton's planes are f32) and newton's f32 calls, on full
    and half storage, by the one-pass call and by the step-kernel chain:
    device time with the L2 flushed by a read before each call."""
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    rng = np.random.default_rng(SEED + 61)
    n = NEWTON_N
    out = {}
    for sym in (False, True):
        ck, dk, lk, b, x0, xr = k2_levels(dev, rng, n, n, 1, sym)
        for name, (a, kw) in k2_call_forms(ck, dk, lk, b, x0, xr).items():
            if name not in ("presmooth_resid_bf16", "postsmooth_bf16",
                            "presmooth_resid_f32", "postsmooth_f32"):
                continue
            key = f"{name}{' sym' if sym else ''}"
            out[key] = {
                label: device_ms(run, between=flush_clean)
                for label, run in (
                    ("one_pass", lambda: fs.fused_sweeps_2d(*a, **kw)),
                    ("step_chain", lambda: k2_step_chain(a, kw)))}
            log(f"K2{'-sym' if sym else ''} {name} {n}x{n} nd=1, "
                f"read-flushed device: one-pass {fms(out[key]['one_pass'])} "
                f"ms, step chain {fms(out[key]['step_chain'])} ms")
        del ck, dk, lk, b, x0, xr
    return out


def run_k2_witness():
    """``python3 chip_smoke.py --k2-witness [--root DIR]``: on the package
    under DIR, K2's float32 forms against float64
    (:func:`k2_float64_witness`), the nd=1 call forms by both kernels
    (:func:`k2_nd1_forms`) and ptxas's registers of the one-pass
    kernel; prints the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--root" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    dev = torch.device("cuda", 0)
    _cuda.library()
    regs = {k: short_ptxas(_cuda.build_log, k)
            for k in ("sweeps_2d_kernel", "sweeps_2d_kernel_b2")}
    log(f"ptxas: {regs}")
    out = dict(ptxas=regs, witness=k2_float64_witness(dev),
               nd1=k2_nd1_forms(dev, l2_flush_clean(dev)))
    log(card_line())
    log(json.dumps({"package": pt.__file__, **out}))
    return 1 if FAILS else 0


def flush_controls(dev, flush, flush_clean):
    """What each flush costs the call timed after it: an elementwise
    product that reads 11.6 MB and writes 11.6 MB (the bytes of K9 nd=1
    f32 at 1025x513), its device time after each flush and back to
    back."""
    import torch

    t = torch.ones(2_887_500, dtype=torch.float32, device=dev)
    y = torch.empty_like(t)
    run = lambda: torch.mul(t, 2.0, out=y)
    out = dict(stencil_times(run, flush, flush_clean),
               bound_ms=bound(nbytes(t, y), t.numel())[0])
    log(f"flush control, 2 x of 11.6 MB into 11.6 MB: device "
        f"{fms(out['device_ms'])} ms "
        f"(write flush) / {fms(out['clean_device_ms'])} (read flush) / "
        f"{fms(out['l2_warm_device_ms'])} (back to back), bound "
        f"{out['bound_ms']:.4f} ms")
    return out


def solve_rows(dev, pt):
    """The main paths that run K2 and K9, with the counts zeroed just
    before one run and read just after: bench 2D, bench 2D sym and 4d
    (PCG iterations, K2 launches, CUDA-event and device time of one
    assemble+solve, busy share), newton (Newton iterations, K2 and K9
    launches, the same times) and topo (2 warm-up and 4 MMA iterations:
    state and filter iterations of each, K2 launches of the 4)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )
    from pyfem_gpu_testflight_tpu_torch.opt import DeviceTopo

    out = {}

    def measured(label, run, reps, iters):
        run()
        torch.cuda.synchronize()
        _cuda.reset_launches()
        k = iters(run())
        torch.cuda.synchronize()
        counts = dict(_cuda.launches)
        ms = cuda_ms(run, reps)
        dms = device_ms(run, reps=reps, sessions=3)
        out[label] = dict(iterations=k, k2_launches=k2_launches(counts),
                          k2_sym_launches=k2_sym_launches(counts),
                          k9_launches=counts.get("pyfem_stencil_2d", 0),
                          ms=ms, device_ms=dms,
                          busy=None if dms is None else dms / ms)
        log(f"{label}: {k} iterations, K2 launches "
            f"{out[label]['k2_launches']} (sym "
            f"{out[label]['k2_sym_launches']}), K9 "
            f"{out[label]['k9_launches']}; {ms:.3f} ms a run (CUDA events), "
            f"device {fms(dms)} ms, busy "
            f"{'not measured' if dms is None else f'{100 * dms / ms:.1f}%'}")

    for label, route in (("bench 2D", {}), ("bench 2D sym", {"sym": True}),
                         ("4d", {"elem_path": "cuda"})):
        _m, _a, rho, rhs, step, _L = bench2d(dev, pt, multigrid, i2p, p2i,
                                             **route)
        measured(label, lambda: step(rho, rhs, rhs), 5, lambda o: int(o[1]))
        del step
    model = newton_model(pt, dev, NEWTON_N, torch.float32)
    xdv = torch.full((10,), 0.1, dtype=torch.float32, device=dev)
    measured("newton", lambda: model.solve_nonlinear_fused(
        method="gmg", xdv=xdv, **NEWTON_KW), 2, lambda o: int(o[1]))
    del model
    conn, X, fixed, force, _L = problem(NX, NY)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
    model.attach_structured_grid(NX, NY, nu_pre=2, nu_post=2, min_n=5,
                                 smoother_dtype=torch.bfloat16,
                                 omega="cheby")
    filtr = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float32,
                         rtol=1e-6, device=dev)
    filtr.attach_structured_grid(NX, NY)
    dt = DeviceTopo(model, filtr, fixed_volume=0.4, rtol=1e-6, maxiter=200)
    dt.optimize(max_iterations=2, verbose=False, log_every=2)
    dt.history.clear()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    dt.optimize(max_iterations=4, verbose=False, log_every=4)
    torch.cuda.synchronize()
    out["topo"] = dict(
        state_iterations=[int(h["cg_iters"]) for h in dt.history],
        filter_iterations=[[int(v) for v in h["filter_iters"]]
                           for h in dt.history],
        k2_launches=k2_launches(_cuda.launches),
        k9_launches=_cuda.launches["pyfem_stencil_2d"],
        s_per_iter=dt.s_per_iter)
    log(f"topo: state PCG iterations {out['topo']['state_iterations']}, "
        f"filter {out['topo']['filter_iterations']}, K2 launches "
        f"{out['topo']['k2_launches']} and K9 {out['topo']['k9_launches']} "
        f"in 4 MMA iterations, {dt.s_per_iter:.4f} s an iteration")
    return out


def run_stencil_2d_kernels():
    """``python3 chip_smoke.py --stencil-2d-kernels [--root DIR]``: K2,
    K2-sym and K9 alone on the package under DIR (default: this
    checkout), so a parent checkout is timed on the same inputs in the
    same call: every K2 and K2-sym call form (:func:`k2_call_rows`),
    every K9 form (:func:`k9_form_rows`), bench 2D's and bench 2D sym's
    V-cycle calls on every coarser level (:func:`k2_coarse_levels`), what
    each L2 flush costs a timed read
    (:func:`flush_controls`) and the main paths' iterations, launches and
    device time (:func:`solve_rows`); prints the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--root" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    dev = torch.device("cuda", 0)
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 60)
    flush, flush_clean = l2_flush(dev), l2_flush_clean(dev)
    out = {"flush_control": flush_controls(dev, flush, flush_clean)}
    out["K2"], w2 = k2_call_rows(dev, rng, flush, flush_clean)
    out["K2-sym"], w2s = k2_call_rows(dev, rng, flush, flush_clean, sym=True)
    out["K9"], w9 = k9_form_rows(dev, pt, rng, flush, flush_clean)
    out["K2_levels"], w2c, _a = k2_coarse_levels(dev, rng, timed=True)
    out["K2-sym_levels"], w2sc, _a = k2_coarse_levels(dev, rng, timed=True,
                                                      sym=True)
    del flush, flush_clean
    out["solves"] = solve_rows(dev, pt)
    out["ptxas"] = {k: short_ptxas(_cuda.build_log, k)
                    for k in ("smooth_2d_kernel", "sweeps_2d_kernel",
                              "sweeps_2d_kernel_b2",
                              "stencil_2d_kernel")}
    log(card_line())
    log(json.dumps({"package": pt.__file__,
                    "worst_rel_err": max(w2, w2c, w2s, w2sc, w9),
                    **out}))
    return 1 if FAILS else 0


# bench 3D's levels (65^3 down to 5^3, coarsest 3^3 dense)
PASS_LEVELS = (65, 33, 17, 9, 5)


def pass_levels(dev):
    """Device time per call (``torch.profiler``) on every level of bench
    3D of the stencil passes it runs: K4's sweep pass on bf16 and f32
    half-storage planes and on bf16 full planes, K4's f32 matvec, K5's
    bf16 presmooth+residual (two passes and the elementwise first sweep)
    and K6's f32 matvec and sweep pass, each held against its plain
    version (a residual of max|b|).  It uses only the package's public
    functions, so ``--pass-levels --root DIR`` times a parent checkout's
    kernels on the same inputs.  Returns {n: {name: ms}} and the worst
    error relative to max|plain|."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    rng = np.random.default_rng(SEED + 30)
    times, worst = {}, 0.0
    for n in PASS_LEVELS:
        shape = (3, n, n, n)
        a = multigrid.GMGAssembler3D(n, n, n, 1.0, 1.0, 1.0, "elasticity",
                                     p=3.0, device=dev)
        st = a.static_levels[0]
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (n, n, n)),
                              dtype=torch.float32, device=dev)
        args = (rho, st.maskf, st.W, a.N)
        kw = dict(nd=3, p=3.0, lp_dtype=torch.bfloat16)
        ck, dk, lk = fa.assemble_pack_3d(*args, **kw)
        _cf, _df, lkf = fa.assemble_pack_3d(*args, sym=False, **kw)
        del _cf, _df
        field = lambda: torch.as_tensor(rng.standard_normal(shape),
                                        dtype=torch.float32, device=dev)
        b = torch.where(st.mask, 0.0, field())
        x0 = torch.where(st.mask, 0.0, field())
        ao = multigrid.GMGAssembler3D(n, n, n, 1.0, 1.0, 1.0, "elasticity",
                                      p=3.0, device=dev, elem_path="otf")
        _g, lv = ao.assemble(rho.reshape(-1))
        ov = (lv.rho, lv.maskf, lv.w3, lv.wd)
        om2 = multigrid.smoothing_omegas(2, 3.0)
        sweep = dict(mode="sweep", omega=0.5)
        calls = {
            "sweep_sym_bf16": (fs.fused_sweep_3d, fs.fused_sweep_3d_plain,
                               (lk, dk, b, x0), sweep),
            "sweep_sym_f32": (fs.fused_sweep_3d, fs.fused_sweep_3d_plain,
                              (ck, dk, b, x0), sweep),
            "sweep_full_bf16": (fs.fused_sweep_3d, fs.fused_sweep_3d_plain,
                                (lkf, dk, b, x0), sweep),
            "matvec_sym_f32": (fs.fused_sweep_3d, fs.fused_sweep_3d_plain,
                               (ck, None, None, x0),
                               dict(mode="matvec", neg_resid=True)),
            "k5_presmooth_resid_bf16": (
                fs.fused_sweeps3d, fs.fused_sweeps3d_plain,
                (lk, dk, b, None), dict(niter=2, want_resid=True,
                                        omega=om2)),
            "k6_matvec_f32": (otf3d.otf_apply_3d, otf3d.otf_apply_3d_plain,
                              ov + (None, x0),
                              dict(niter=0, neg_resid=True, p=lv.p)),
            "k6_sweep_f32": (otf3d.otf_apply_3d, otf3d.otf_apply_3d_plain,
                             ov + (b, x0), dict(niter=1, want_resid=False,
                                                omega=0.5, p=lv.p)),
        }
        times[n] = {}
        bmax = float(b.abs().max())
        for name, (fn, plain, fa_args, fkw) in calls.items():
            got, ref = fn(*fa_args, **fkw), plain(*fa_args, **fkw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for i, (g, r) in enumerate(zip(got, ref)):
                scale = float(r.abs().max())
                if i == 1:  # a residual after sweeps: of max|b|
                    scale = max(scale, bmax)
                worst = max(worst, float((g - r).abs().max()) / scale)
            times[n][name] = device_ms(lambda: fn(*fa_args, **fkw))
    check(worst <= REL_TOL, f"stencil passes on every level within "
          f"{REL_TOL:g} of max|plain| (worst {worst:.2e})")
    return times, worst


def run_solution_floor():
    """``python3 chip_smoke.py --solution-floor [--root DIR]``: only
    :func:`solution_floor`, on the package under DIR (default: this
    checkout); prints the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--root" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p,
    )

    log(card_line())
    errs = solution_floor(torch.device("cuda", 0), pt, multigrid, i2p)
    log(json.dumps({"package": pt.__file__, "solution_errors": errs}))
    return 0


def run_pass_levels():
    """``python3 chip_smoke.py --pass-levels [--root DIR]``: only
    :func:`pass_levels`, on the package under DIR (default: this
    checkout); prints the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if "--root" in sys.argv:
        sys.path.insert(0, sys.argv[sys.argv.index("--root") + 1])
    import pyfem_gpu_testflight_tpu_torch as pt

    log(card_line())
    times, worst = pass_levels(torch.device("cuda", 0))
    log(json.dumps({"package": pt.__file__, "worst_rel_err": worst,
                    "device_ms": times}))
    return 1 if FAILS else 0


def k6_passes(lv, b, x, kw):
    """One K6 call's stencil passes one at a time, each beside the plain
    version fed the same input (the kernel's previous pass).

    Returns ([(name, kernel, plain, is_residual)], the last pass's kernel
    outputs).  Pass by pass, because with bf16 operands every pass
    rounds its iterate to bf16: a float32 summation-order difference of
    ~1e-7 in one pass can flip a rounding and move the next pass by a
    bf16 ulp, so a whole multi-pass call differs from its plain version
    by up to ~1e-4 although every pass agrees to float32 rounding.
    """
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d
    from pyfem_gpu_testflight_tpu_torch.ops.fused_smooth import _omega_seq

    args = (lv.rho, lv.maskf, lv.w3, lv.wd)
    common = dict(p=lv.p, mxu_bf16=kw.get("mxu_bf16", False))
    pairs = []
    for i, om in enumerate(_omega_seq(kw.get("omega", 0.6), kw["niter"])):
        one = dict(niter=1, want_resid=False, omega=om, **common)
        k = otf3d.otf_apply_3d(*args, b, x, **one)
        pairs.append((f"sweep {i}", k,
                      otf3d.otf_apply_3d_plain(*args, b, x, **one), False))
        x = k
    last = [x] if kw["niter"] else []
    if kw.get("want_resid", True):
        one = dict(niter=0, neg_resid=kw.get("neg_resid", False), **common)
        k = otf3d.otf_apply_3d(*args, b, x, **one)
        pairs.append(("residual", k,
                      otf3d.otf_apply_3d_plain(*args, b, x, **one), True))
        last.append(k)
    return pairs, last


def phase_kernels_otf(dev, build_log):
    """Phase 3b: K6 against its plain version on the card, pass by pass
    (``k6_passes``), and each whole call equal to its passes; the bf16
    calls run the tensor-core body (``pyfem_otf_3d_tc``), the f32 ones the
    CUDA-core body.  Then one sweep pass at 65^3 timed on both bodies,
    in turns."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    rng = np.random.default_rng(SEED + 20)
    res = {}
    worst = worst_tc = 0.0
    for (nx, ny, nz), physics in (((N3, N3, N3), "elasticity"),
                                  ((9, 7, 5), "elasticity"),
                                  ((9, 7, 5), "poisson")):
        a = multigrid.GMGAssembler3D(nx, ny, nz, (nx - 1) / (ny - 1), 1.0,
                                     (nz - 1) / (ny - 1), physics, p=3.0,
                                     device=dev, elem_path="otf")
        nd = a.nd
        rho = torch.as_tensor(rng.uniform(0.2, 1.0, (nz, ny, nx)),
                              dtype=torch.float32, device=dev)
        _g, lv = a.assemble(rho)
        field = lambda: torch.as_tensor(rng.standard_normal((nd, nz, ny, nx)),
                                        dtype=torch.float32, device=dev)
        b = torch.where(lv.mask, 0.0, field())
        x0 = torch.where(lv.mask, 0.0, field())
        om2 = multigrid.smoothing_omegas(2, 3.0)
        calls = {"matvec_f32": ((None, x0), dict(niter=0, neg_resid=True))}
        for cname, bf in (("f32", False), ("bf16", True)):
            calls[f"presmooth_resid_{cname}"] = (
                (b, None), dict(niter=2, omega=om2, mxu_bf16=bf))
            calls[f"postsmooth_{cname}"] = (
                (b, x0), dict(niter=2, want_resid=False, omega=om2[::-1],
                              mxu_bf16=bf))
        calls["presmooth_resid_nu4_f32"] = (
            (b, None), dict(niter=4, omega=multigrid.smoothing_omegas(4, 3.0)))
        tag = f"K6 {nx}x{ny}x{nz} nd={nd}"
        for name, ((bb, xx), kw) in calls.items():
            kw = dict(kw, p=lv.p)
            args = (lv.rho, lv.maskf, lv.w3, lv.wd, bb, xx)
            got = otf3d.otf_apply_3d(*args, **kw)
            ref = otf3d.otf_apply_3d_plain(*args, **kw)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            pairs, last = k6_passes(lv, bb, xx, kw)
            torch.cuda.synchronize()
            same = all(torch.equal(g, l) for g, l in zip(got, last))
            errs = []
            for pname, k, r, is_resid in pairs:
                d = float((k - r).abs().max())
                scale = float(r.abs().max())
                if is_resid and bb is not None:
                    # a residual after damping sweeps is rounded at b's
                    # scale (as K5's nu=4 check)
                    scale = max(scale, float(bb.abs().max()))
                if kw.get("mxu_bf16"):
                    worst_tc = max(worst_tc, d)
                else:
                    worst = max(worst, d)
                errs.append(d / scale)
            whole = max(rel_err(g, r)[1] for g, r in zip(got, ref))
            log(f"{tag} {name}: per pass rel "
                + ", ".join(f"{e:.2e}" for e in errs)
                + f"; whole call vs plain {whole:.2e}; call == its passes "
                f"{same}")
            check(max(errs) <= REL_TOL, f"{tag} {name} within {REL_TOL:g}")
            check(same, f"{tag} {name} call equals its passes bit for bit")
        if (nx, ny, nz) != (N3, N3, N3):
            continue
        n3 = rho.numel()
        # per node: 512 weight FMAs per (ca, cb) pair (the structurally
        # nonzero ones), 27 nd^2 Y products, 64 for the material; 2 flops
        flops = 2 * (nd * nd * (512 + 27) + 64) * n3
        for name in ("matvec_f32", "presmooth_resid_bf16",
                     "postsmooth_bf16", "presmooth_resid_f32"):
            (bb, xx), kw = calls[name]
            kw = dict(kw, p=lv.p)
            args = (lv.rho, lv.maskf, lv.w3, lv.wd, bb, xx)
            ms = cuda_ms(lambda: otf3d.otf_apply_3d(*args, **kw), 20)
            pms = cuda_ms(lambda: otf3d.otf_apply_3d_plain(*args, **kw), 3)
            log(f"K6 {name} {N3}^3: kernel {ms:.4f} ms, plain {pms:.4f} ms")
            if name == "matvec_f32":
                b_ms, b_by = bound(nbytes(rho, lv.maskf, lv.w3, lv.wd, xx)
                                   + nbytes(xx), flops)
                # the yardstick: the same operator as an f32 CSR matvec
                full, _d = fa.assemble_pack_3d_plain(
                    rho, lv.maskf, a.static_levels[0].W, a.N, nd=nd, p=3.0,
                    sym=False)
                lib = library_matvec_ms(full.reshape(nd, nd, 3, 3, 3, *rho.shape),
                                        tuple(rho.shape), xx)
                del full
                res["K6"] = dict(ms=ms, plain_ms=pms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib,
                                 device_ms=device_ms(
                                     lambda: otf3d.otf_apply_3d(*args, **kw)))
                log(f"K6 matvec_f32 {N3}^3: bound {b_ms:.4f} ms ({b_by}; "
                    f"{flops / 1e9:.2f} GFLOP, dense TPU count "
                    f"{2 * nd * (64 * 27 * nd + 64) * n3 / 1e9:.2f}), "
                    f"torch.sparse.mm (f32 CSR) {lib:.4f} ms")
        # one sweep pass from a given x: f32 (CUDA cores) and bf16
        # operands (tensor cores) in turns
        args = (lv.rho, lv.maskf, lv.w3, lv.wd, b, x0)
        sw = dict(niter=1, want_resid=False, omega=0.5, p=lv.p)
        f32 = lambda: otf3d.otf_apply_3d(*args, mxu_bf16=False, **sw)
        tc = lambda: otf3d.otf_apply_3d(*args, mxu_bf16=True, **sw)
        t = [cuda_ms(f, 20) for f in (f32, tc, tc, f32)]
        pms = cuda_ms(lambda: otf3d.otf_apply_3d_plain(
            *args, mxu_bf16=True, **sw), 3)
        io = nbytes(rho, lv.maskf, lv.w3, lv.wd, b, x0) + nbytes(x0)
        f_ms, f_by = bound(io, flops)
        # what the pass needs: the structurally nonzero products (8 nd
        # weights per (ca, o, q)) on the bf16 tensor cores; in f32 on the
        # CUDA cores, which run beside them, sum_j B_j Z_j and the inverse
        # diagonal (nd * 64 each) and the material (64) per node
        tc_ops = 2 * nd * nd * 512 * n3
        cc_ops = 2 * (2 * nd * 64 + 64) * n3
        t_b, t_o = io / HBM_BYTES_S, max(tc_ops / BF16_FLOP_S,
                                         cc_ops / F32_FLOP_S)
        t_ms, t_by = 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else \
            "operations"
        regs = [v for k, v in ptxas_table(build_log).items()
                if "otf_3d_tc_kernelILi3E" in k]
        log(f"K6 sweep pass {N3}^3: f32 (CUDA cores) {t[0]:.4f} / "
            f"{t[3]:.4f} ms, bound {f_ms:.4f} ms ({f_by}); bf16 operands "
            f"(tensor cores) {t[1]:.4f} / {t[2]:.4f} ms, bound {t_ms:.4f} ms "
            f"({t_by}; {io / 1e6:.2f} MB, {tc_ops / 1e9:.2f} GFLOP bf16, "
            f"{cc_ops / 1e9:.2f} GFLOP f32); plain {pms:.4f} ms; ptxas "
            f"{regs}")
        ms = min(t[1], t[2])
        d = [device_ms(f) for f in (f32, tc)]
        log(f"K6 sweep pass {N3}^3, device time (profiler): f32 {fms(d[0])} "
            f"ms, bf16 operands (tensor cores) {fms(d[1])} ms")
        log(f"K6 bf16 sweep pass at most half the f32 pass (same run): CUDA "
            f"events {'met' if ms <= 0.5 * min(t[0], t[3]) else 'NOT met'}, "
            f"device time {verdict(None not in d and d[1] <= 0.5 * d[0], None not in d)}")
        res["K6-tc"] = dict(ms=ms, plain_ms=pms, bound_ms=t_ms, bound_by=t_by,
                            library_ms=None, f32_pass_ms=min(t[0], t[3]),
                            device_ms=d[1], f32_pass_device_ms=d[0],
                            ptxas=regs[0] if regs else None)
    res["K6"]["max_abs_err"] = worst
    res["K6-tc"]["max_abs_err"] = worst_tc
    # the f32 body on every level (timed by pass_levels in phase 3a)
    for n in PASS_LEVELS:
        t = PASS_TIMES[n]
        log(f"K6 f32 body {n}^3, device time (profiler): matvec "
            f"{fms(t['k6_matvec_f32'])} ms, sweep pass {fms(t['k6_sweep_f32'])} "
            f"ms")
    regs = short_ptxas(build_log, "otf_3d_kernel")
    log(f"ptxas otf_3d_kernel: {regs}")
    res["K6"].update(ptxas=regs, levels_device_ms={
        n: {k: PASS_TIMES[n][k] for k in ("k6_matvec_f32", "k6_sweep_f32")}
        for n in PASS_LEVELS})
    return res


def solve_and_measure(step, args, names, label):
    """Warm-up solve, then one solve with the named counts zeroed just
    before and read just after; returns (outputs, counts, ms)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    t0 = time.time()
    step(*args)  # first call: library and allocator warm-up
    torch.cuda.synchronize()
    log(f"{label}: first (cold) solve {1e3 * (time.time() - t0):.1f} ms "
        f"host clock")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _cuda.reset_launches()
    e0.record()
    out = step(*args)
    e1.record()
    e1.synchronize()
    # .get: a parent checkout (--root) may lack an entry
    counts = {k: _cuda.launches.get(k, 0) for k in names}
    return out, counts, e0.elapsed_time(e1)


# position of the grid's nz among each 3D entry point's arguments
_NZ_ARG = {"pyfem_assemble_3d": 6, "pyfem_sweep_3d": 8,
           "pyfem_sweeps_3d": 13, "pyfem_otf_3d": 8, "pyfem_otf_3d_tc": 9}


def launches_by_level(step, args):
    """One more run of ``step`` with every 3D smoother/operator launch
    tallied by entry point and grid level (its nz): {entry: {nz: n}}.
    A run of its own, so the tally costs the timed solves nothing."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    tally = {name: {} for name in _NZ_ARG}
    launch = _cuda.launch

    def counting(name, *a):
        launch(name, *a)
        if name in tally:
            nz = a[_NZ_ARG[name]]
            tally[name][nz] = tally[name].get(nz, 0) + 1

    _cuda.launch = counting
    try:
        step(*args)
        torch.cuda.synchronize()
    finally:
        _cuda.launch = launch
    return {k: dict(sorted(v.items(), reverse=True)) for k, v in tally.items()
            if v}


def k2_per_call(run, entries=K2_ENTRIES):
    """One more run of ``run`` with every ``fused_sweeps_2d`` call and
    every launch of ``entries`` (K2's, or K2-sym's) counted: (calls,
    launches)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth

    calls = [0]
    sweeps = fused_smooth.fused_sweeps_2d

    def counting(*a, **kw):
        calls[0] += 1
        return sweeps(*a, **kw)

    fused_smooth.fused_sweeps_2d = counting
    n0 = k2_launches(_cuda.launches, entries)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        fused_smooth.fused_sweeps_2d = sweeps
    return calls[0], k2_launches(_cuda.launches, entries) - n0


def chained_ms(step, rho, rhs, u, n_chain=10):
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n_chain):
        u = step(rho, rhs, u)[0]
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n_chain


def breakdown(label, step, args, asm, rho, b, single_ms):
    """Where one solve's time goes: CUDA-event times of the hierarchy
    assembly, the PCG solve, one V-cycle and one fine-level matvec, then
    one assemble+solve under ``torch.profiler``: the kernels' device
    time, the launches, and the device busy share of ``single_ms``.
    Returns the hierarchy-assembly milliseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pyfem_gpu_testflight_tpu_torch import multigrid

    def timed(fn, reps=1):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1) / reps

    (gmg, lv0), asm_ms = timed(lambda: asm.assemble(rho))
    (_x, k, _rn), pcg_ms = timed(lambda: multigrid.pcg_gmg(
        gmg, lv0, b, rtol=1e-6, maxiter=200, flexible=True))
    _, vc_ms = timed(lambda: gmg.apply(b), 5)
    _, mv_ms = timed(lambda: lv0.matvec(b), 20)
    log(f"{label} breakdown (CUDA events): hierarchy assembly {asm_ms:.3f} "
        f"ms, PCG {pcg_ms:.3f} ms ({k} iterations), one V-cycle "
        f"{vc_ms:.3f} ms, one fine matvec {mv_ms:.4f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*args)
        torch.cuda.synchronize()

    rows = device_rows(prof)
    busy_ms = sum(dev_us(r) for r in rows) / 1e3
    if not rows:
        log(f"{label} profile: no device time recorded (busy share not "
            f"measured)")
        return asm_ms
    DEVICE_MS[label] = busy_ms
    log(f"{label} profile: {sum(r.count for r in rows)} device activities "
        f"(kernels and copies) in one assemble+solve, device time "
        f"{busy_ms:.3f} ms = {100 * busy_ms / single_ms:.1f}% of the "
        f"unprofiled single-shot {single_ms:.3f} ms")
    for r in sorted(rows, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(r) / 1e3:9.3f} ms {r.count:6d}x  {r.key[:90]}")
    return asm_ms


def bench2d(dev, pt, multigrid, i2p, p2i, p=0.0, **route):
    """The 2D bench configuration (bench.py run_2d) through the package's
    public functions: (model, assembler, rho, rhs, step, (Lx, Ly)), where
    ``step(rho, rhs, chain)`` assembles the hierarchy and solves, and
    returns (u, iterations, residual norm, b, gmg).  ``p``: the RAMP
    exponent (the bench's 0; phase 12 runs the step at 3)."""
    import torch

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=p,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler(
        NX, NY, Lx, Ly, "elasticity", p=p, dtype=torch.float32,
        device=dev, nu_pre=2, nu_post=2, min_n=5, coarse_dense_max=4096,
        smoother_dtype=torch.bfloat16, omega="cheby", **route,
    )
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    rhs = model.compute_rhs()

    def step(rho, rhs, chain):
        rho = rho + 0.0 * chain[0]
        gmg, lv0 = asm.assemble(rho)
        b = torch.where(lv0.mask, 0.0, i2p(rhs, 2).reshape(2, NY, NX))
        x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                                     flexible=True)
        return p2i(x.reshape(-1), 2), k, rn, b, gmg

    return model, asm, rho, rhs, step, (Lx, Ly)


def phase_main_2d(dev, pt, multigrid, i2p, p2i, label="bench 2D",
                  **route):
    """Phase 4 (4d with ``elem_path="cuda"``): the 2D bench configuration
    through the port."""
    import torch

    model, asm, rho, rhs, step, (Lx, Ly) = bench2d(dev, pt, multigrid, i2p,
                                                    p2i, **route)
    log(f"main path {label}: {model.ndof} dof, levels {asm.sizes}, route "
        f"{route or 'uniform (K1)'}")

    (u, k, rn, b, gmg), counts, single_ms = solve_and_measure(
        step, (rho, rhs, rhs), ("pyfem_assemble_2d", "pyfem_smooth_2d",
                                "pyfem_sweeps_2d", "pyfem_assemble_2d_sym",
                                "pyfem_smooth_2d_sym", "pyfem_sweeps_2d_sym",
                                "pyfem_elasticity_quad4"), label)
    counts["K2"] = k2_launches(counts)
    counts["K2-sym"] = k2_sym_launches(counts)
    log(f"{label}: {k} PCG iterations (JAX reference: 7), "
        f"||r||/||b|| {float(rn) / float(torch.linalg.norm(b)):.3e}, "
        f"launches {counts}, single-shot {single_ms:.3f} ms")
    check(k <= 8, f"{label} converges in <= 8 iterations")
    check(float(rn) <= 1e-6 * float(torch.linalg.norm(b)),
          f"{label} PCG residual <= rtol")
    check(bool(torch.isfinite(u).all()) and u.shape == (model.ndof,),
          f"{label} solution finite, shape (ndof,)")
    if route.get("sym"):
        check(counts["pyfem_assemble_2d_sym"] == len(gmg.levels)
              and counts["pyfem_sweeps_2d_sym"] > 0
              and counts["pyfem_assemble_2d"] == 0 and counts["K2"] == 0,
              f"{label}: K1-sym once per level ({len(gmg.levels)}), K2-sym "
              f"launched ({counts['K2-sym']} a solve), no full-storage "
              f"K1/K2 launch")
    elif route.get("elem_path", "uniform") == "uniform":
        check(counts["pyfem_assemble_2d"] == len(gmg.levels)
              and counts["K2"] > 0
              and counts["pyfem_assemble_2d_sym"] == 0,
              f"{label}: K1 once per level ({len(gmg.levels)}), K2 "
              f"launched, no K1-sym launch")
    else:
        check(counts["pyfem_elasticity_quad4"] == len(gmg.levels)
              and counts["pyfem_assemble_2d"] == 0 and counts["K2"] > 0,
              f"{label}: K7a once per level ({len(gmg.levels)}), no K1, K2 "
              f"launched")
    k2 = "K2-sym" if route.get("sym") else "K2"
    calls, nk2 = k2_per_call(lambda: step(rho, rhs, rhs), K2_SYM_ENTRIES
                             if route.get("sym") else K2_ENTRIES)
    log(f"{label}: {calls} smoothing calls, {nk2} {k2} launches")
    check(calls > 0 and nk2 == calls,
          f"{label}: one {k2} launch per smoothing call ({calls})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(rho, rhs, rhs)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    log(f"{label}: peak device memory of one assemble+solve {mem / 2**20:.1f} "
        f"MiB above the {base / 2**20:.1f} MiB allocated before it")
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho, 0.0, dev)
    x = i2p(u, 2).reshape(2, NY, NX)
    true, floor = residuals(mv64, mvabs, b, x)
    log(f"{label}: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f}); <= 1e-5: {true <= 1e-5}")
    check(true <= FLOOR_FACTOR * floor,
          f"{label} true residual <= {FLOOR_FACTOR:g} x float32 floor")
    xa, ka, rna = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    err = float(torch.linalg.norm(x.double() - xa) / torch.linalg.norm(xa))
    log(f"{label} float64 outer PCG, float32 kernel V-cycle: {ka} "
        f"iterations, true residual {true_a:.3e}; the float32 solve's "
        f"rel L2 error against it {err:.3e}")
    check(true_a <= 1e-5, f"{label} float64-outer true residual <= 1e-5")
    ch = chained_ms(step, rho, rhs, u)
    log(f"{label}: chained {ch:.3f} ms/solve over 10")
    asm_ms = breakdown(label, step, (rho, rhs, rhs), asm, rho, b, single_ms)
    return dict(counts=counts, single_ms=single_ms, ch=ch, u=u, k=k,
                mem=mem, asm_ms=asm_ms, true=true, floor=floor, err=err,
                nlevels=len(gmg.levels))


def phase_main_3d(dev, pt, multigrid, i2p, p2i, label="bench 3D",
                  full=True, **route):
    """Phases 4a-4c: the 3D bench configuration (bench.py run_3d) on
    the assembled route (4a), the on-the-fly route
    (``elem_path="otf"``, 4b) or full coefficient storage (``sym=False``,
    4c); ``full=False`` skips the chained time and the breakdown."""
    import torch

    n = N3
    conn, X, fixed, force, L = problem(n, n, n)
    model = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler3D(
        n, n, n, *L, "elasticity", p=0.0, dtype=torch.float32, device=dev,
        nu_pre=2, nu_post=2, min_n=3, coarse_dense_max=4096,
        smoother_dtype=torch.bfloat16, omega="cheby", **route,
    )
    log(f"main path {label}: {model.ndof} dof, levels {asm.sizes}, "
        f"route {route or 'assembled, sym storage'}")
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    rhs = model.compute_rhs()

    def step(rho, rhs, chain):
        rho = rho + 0.0 * chain[0]
        gmg, lv0 = asm.assemble(rho)
        b = torch.where(lv0.mask, 0.0, i2p(rhs, 3).reshape(3, n, n, n))
        x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                                     flexible=True)
        return p2i(x.reshape(-1), 3), k, rn, b, gmg

    names = ("pyfem_assemble_3d", "pyfem_sweep_3d", "pyfem_sweeps_3d",
             "pyfem_otf_3d", "pyfem_otf_3d_tc")
    (u, k, rn, b, gmg), counts, single_ms = solve_and_measure(
        step, (rho, rhs, rhs), names, label)
    log(f"{label}: {k} PCG iterations (JAX reference: 7), "
        f"||r||/||b|| {float(rn) / float(torch.linalg.norm(b)):.3e}, "
        f"launches {counts}, single-shot {single_ms:.3f} ms")
    by_level = launches_by_level(step, (rho, rhs, rhs))
    log(f"{label}: launches by entry point and level (nz: count) "
        f"{by_level}")
    check(k <= 8, f"{label} converges in <= 8 iterations")
    check(float(rn) <= 1e-6 * float(torch.linalg.norm(b)),
          f"{label} PCG residual <= rtol")
    check(bool(torch.isfinite(u).all()) and u.shape == (model.ndof,),
          f"{label} solution finite, shape (ndof,)")
    # the solve's own peak device memory, above what was allocated before
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(rho, rhs, rhs)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    log(f"{label}: peak device memory of one assemble+solve {mem / 2**20:.1f} "
        f"MiB above the {base / 2**20:.1f} MiB allocated before it")
    mv64, mvabs, _ = f64_operator_3d(n, L, rho, 0.0, dev)
    x = i2p(u, 3).reshape(3, n, n, n)
    true, floor = residuals(mv64, mvabs, b, x)
    log(f"{label}: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f}); <= 1e-5: {true <= 1e-5}")
    check(true <= FLOOR_FACTOR * floor,
          f"{label} true residual <= {FLOOR_FACTOR:g} x float32 floor")
    xa, ka, _ = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    log(f"{label} float64 outer PCG, float32 kernel V-cycle: {ka} "
        f"iterations, true residual {true_a:.3e}")
    check(true_a <= 1e-5, f"{label} float64-outer true residual <= 1e-5")
    err64, ctl64 = solution_errors(gmg, gmg.levels[0], b, x, xa)
    log(f"{label}: the float32 solution's max-abs error against the "
        f"float64-outer one {err64:.3e} of max; control, the same PCG on "
        f"the bf16 operator: {ctl64:.3e}")
    check(err64 <= SOL64_TOL, f"{label} float32 solution within "
          f"{SOL64_TOL:g} of the float64-outer solution")
    check(not ctl64 <= SOL64_TOL, f"{label} control: the PCG on the bf16 "
          f"operator is not within {SOL64_TOL:g}")
    out = dict(counts=counts, single_ms=single_ms, u=u, k=k, mem=mem,
               err64=err64,
               ch=None, levels=[type(lv).__name__ for lv in gmg.levels],
               by_level=by_level, nlevels=len(gmg.levels))
    if full:
        out["ch"] = chained_ms(step, rho, rhs, u)
        log(f"{label}: chained {out['ch']:.3f} ms/solve over 10")
        breakdown(label, step, (rho, rhs, rhs), asm, rho, b, single_ms)
    return out


def bf16_operator(lv):
    """A level's PCG operator in bf16, the control of
    :func:`solution_errors`: the smoother's bf16 planes (assembled
    levels) or K6's bf16 tensor-core pass (on-the-fly levels)."""
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d

    if getattr(lv, "coeff_lp", None) is not None:
        return lambda u: fs.fused_sweep_3d(lv.coeff_lp, x=u, mode="matvec",
                                           neg_resid=True)
    return lambda u: otf3d.otf_apply_3d(
        lv.rho, lv.maskf, lv.w3, lv.wd, None, u, niter=0, want_resid=True,
        neg_resid=True, p=lv.p, mxu_bf16=True)


def solution_errors(gmg, lv0, b, x, xa):
    """(err, control): the max-abs error, of max|xa|, of the float32 PCG
    solution ``x`` against the float64-outer one ``xa``, and of the same
    PCG (rtol 1e-6, the V-cycle as preconditioner) run on the level's
    bf16 operator (:func:`bf16_operator`), which ``SOL64_TOL`` must tell
    from a sound solve."""
    from pyfem_gpu_testflight_tpu_torch import multigrid

    scale = float(xa.abs().max())
    err = float((x.double() - xa).abs().max()) / scale
    xc, _k, _rn = multigrid.pcg(bf16_operator(lv0), gmg.apply, b, rtol=1e-6,
                                maxiter=200, flexible=True)
    return err, float((xc.double() - xa).abs().max()) / scale


def solution_floor(dev, pt, multigrid, i2p, seeds=(1, 2, 3)):
    """``--solution-floor``: :func:`solution_errors` of bench 3D's three
    routes (assembled half storage, ``sym=False``, ``elem_path="otf"``)
    for its own load and for seeded standard-normal loads on the free
    dofs, the float64-outer solution solved once per load.  Uses only the
    package's public functions, so ``--root DIR`` reads another
    checkout's kernels on the same inputs.  Returns {route: {load:
    [err, control]}}."""
    import torch

    n = N3
    conn, X, fixed, force, L = problem(n, n, n)
    model = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    mv64, _mvabs, _ = f64_operator_3d(n, L, rho, 0.0, dev)
    rhs = i2p(model.compute_rhs(), 3).reshape(3, n, n, n)
    out, ref = {}, {}
    for route, kw in (("assembled", {}), ("sym=False", dict(sym=False)),
                      ("otf", dict(elem_path="otf"))):
        asm = multigrid.GMGAssembler3D(
            n, n, n, *L, "elasticity", p=0.0, dtype=torch.float32,
            device=dev, nu_pre=2, nu_post=2, min_n=3, coarse_dense_max=4096,
            smoother_dtype=torch.bfloat16, omega="cheby", **kw)
        gmg, lv0 = asm.assemble(rho)
        out[route] = {}
        for seed in (None,) + tuple(seeds):
            load = "bench" if seed is None else f"seed {seed}"
            if seed is None:
                f = rhs
            else:
                f = torch.as_tensor(
                    np.random.default_rng(SEED + 40 + seed).standard_normal(
                        (3, n, n, n)), dtype=torch.float32, device=dev)
            b = torch.where(lv0.mask, 0.0, f)
            if load not in ref:
                ref[load] = accuracy_solve(gmg, mv64, b)[0]
            x, _k, _rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6,
                                           maxiter=200, flexible=True)
            out[route][load] = list(solution_errors(gmg, lv0, b, x,
                                                    ref[load]))
            log(f"{route} {load}: float32 solution {out[route][load][0]:.3e}"
                f", bf16-operator control {out[route][load][1]:.3e}")
    return out


def phase_model(dev, pt, etype, dims, label, **gmg_options):
    """Phases 5 / 5a / 5b: ``LinearElasticity.solve(method="gmg")``."""
    import torch

    conn, X, fixed, force, _L = problem(*dims)
    nn = int(np.prod(dims))
    for rlabel, rho_m in (
        ("rho=0.6", 0.6),
        ("rho~U[0.3,1]",
         np.random.default_rng(SEED + 1).uniform(0.3, 1.0, nn)),
    ):
        m = pt.LinearElasticity(etype, X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
        m.attach_structured_grid(*dims, **gmg_options)
        t0 = time.time()
        um = m.solve(method="gmg", rho=rho_m, rtol=1e-6)
        torch.cuda.synchronize()
        st = m.last_solve_stats
        log(f"{label} LinearElasticity.solve gmg {rlabel}: {st['iters']} "
            f"iterations, ||r|| {st['resnorm']:.3e}, "
            f"{time.time() - t0:.3f} s")
        check(bool(torch.isfinite(um).all()) and um.shape == (m.ndof,),
              f"{label} model solve {rlabel} finite")


def bc_residuals(m64, Ke64, b, u):
    """(float64 true relative residual, float32 floor) of ``u`` on the
    Dirichlet-constrained system of ``m64`` (float64 element matrices
    ``Ke64``): ||b - A u|| / ||b|| and u32 || |A| |u| || / ||b||."""
    import torch

    mask = m64.bc.mask
    u64, b64 = u.to(torch.float64), b.to(torch.float64)
    Au = torch.where(mask, u64, m64.matvec(Ke64, torch.where(mask, 0.0, u64)))
    ua = u64.abs()
    Aa = torch.where(mask, ua, m64.matvec(Ke64.abs(),
                                          torch.where(mask, 0.0, ua)))
    bn = float(torch.linalg.norm(b64))
    return (float(torch.linalg.norm(b64 - Au)) / bn,
            2.0 ** -24 * float(torch.linalg.norm(Aa)) / bn)


def phase_general(dev, pt, label, physics, etype="hex8", dims=(N3,) * 3):
    """Phases 5c / 5d / 5e: ``LinearElasticity`` / ``LinearPoisson``
    (gfunc = 1) on a jittered mesh (hex8 at 65^3, or quad4 at 1025x513
    for 5e), ``kernel="cuda"``, float32, ``solve(method="cg",
    rho~U[0.3,1], rtol=1e-6)``: the general-mesh element path (K8 or K7
    -> matrix-free operator -> Jacobi-PCG).  The kernel's launches are
    those of one solve; afterwards the kernel is held against its plain
    version on that solve's inputs."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    key = ("pyfem_stiffness_3d" if etype != "quad4" else
           "pyfem_elasticity_quad4" if physics == "elasticity" else
           "pyfem_poisson_quad4")
    label = f"{label} {etype} {physics} {'x'.join(map(str, dims))}"
    mesh = elem_problem(dims, "quad" if etype == "quad4" else "block",
                        SEED + 40)
    rho = np.random.default_rng(SEED + 41).uniform(0.3, 1.0, len(mesh[1]))
    make = lambda dtype, kernel: make_model(  # noqa: E731
        pt, physics, etype, mesh, dtype, kernel, dev)
    m = make(torch.float32, "cuda")
    log(f"{label}: {m.ndof} dof, {m.nelems} elements, jittered mesh")
    ej_ms = cuda_ms(lambda: m.element_jacobian(rho), 5)
    out = {}
    for name in ("cuda", "cuda again", "einsum"):
        mm = make(torch.float32, "einsum") if name == "einsum" else m
        mm.solve(method="cg", rho=rho, rtol=0.5)  # warm-up
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.time()
        u = mm.solve(method="cg", rho=rho, rtol=1e-6)
        torch.cuda.synchronize()
        st = dict(mm.last_solve_stats, seconds=time.time() - t0,
                  launches=_cuda.launches[key])
        out[name] = (u, st)
        log(f"{label} kernel={name.split()[0]}: {st['iters']} CG "
            f"iterations, {st['readbacks']} host read-backs, ||r|| "
            f"{st['resnorm']:.3e}, solve (element_jacobian + CG) "
            f"{1e3 * st['seconds']:.1f} ms host clock, {key} launches "
            f"{st['launches']}")
        if name == "einsum":
            del mm
    u, st = out["cuda"]
    ue, ste = out["einsum"]
    # the kernel against its plain version at the shape this path gives it
    fk, fp, _ = stiffness_pair(m, etype, physics, torch.as_tensor(
        rho, dtype=torch.float32, device=dev))
    got, ref = fk(), fp()
    err, rel_k = rel_err(got, ref)
    del got, ref
    log(f"{label}: {key} on this solve's inputs vs plain: rel {rel_k:.2e} "
        f"(abs {err:.2e})")
    if etype != "quad4":
        # element_jacobian reshapes K8's KeT into the operator's layout:
        # the transposed view of a contiguous (nelems, ndpe, ndpe) buffer,
        # so that reshape is the buffer itself
        from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek

        KeT = fk()
        nn = m.nnodes_per_elem * m.ndof_per_node
        Ke = ek.untranspose(KeT, nn, nn)
        check(Ke.data_ptr() == KeT.data_ptr() and Ke.is_contiguous(),
              f"{label}: element_jacobian takes K8's buffer, no layout copy")
        del KeT, Ke
    check(rel_k <= REL_TOL, f"{label}: kernel within {REL_TOL:g} of plain "
          f"on the main path's inputs")
    # where a CG iteration goes: the matrix-free operator and its parts
    from pyfem_gpu_testflight_tpu_torch import assembly

    Ke = m.element_jacobian(rho)
    seg, cd = m.segments, m.conn_dof
    data = (Ke, cd, m.bc.mask, seg)
    fe = torch.bmm(Ke, u[cd].unsqueeze(-1))
    parts = {
        "bc_elem_matvec": cuda_ms(lambda: assembly.bc_elem_matvec(data, u),
                                  10),
        "gather u[conn_dof]": cuda_ms(lambda: u[cd], 10),
        "bmm (element products)": cuda_ms(
            lambda: torch.bmm(Ke, u[cd].unsqueeze(-1)), 10),
        "segment sum": cuda_ms(lambda: seg.sum(fe), 10),
    }
    del Ke, fe
    per_it = 1e3 * st["seconds"] / st["iters"]
    log(f"{label}: one CG iteration {per_it:.3f} ms (solve host time / "
        f"iterations); " + ", ".join(f"{k} {v:.3f} ms"
                                     for k, v in parts.items()))
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    m.solve(method="cg", rho=rho, rtol=1e-6)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    m64 = make(torch.float64, "einsum")
    Ke64 = m64.element_jacobian(rho)
    b = m64.bc.constrain_rhs(m64.compute_rhs(), lambda v: m64.matvec(Ke64, v))
    true, floor = bc_residuals(m64, Ke64, b, u)
    true_e, floor_e = bc_residuals(m64, Ke64, b, ue)
    del Ke64, m64
    rel = float(torch.linalg.norm(u.double() - ue.double())
                / torch.linalg.norm(ue.double()))
    log(f"{label}: element_jacobian {ej_ms:.3f} ms (RAMP at the points, "
        f"kernel, the operator's layout); "
        f"peak device memory of one solve {mem / 2**20:.1f} MiB above "
        f"{base / 2**20:.1f} MiB")
    log(f"{label}: float64 true residual kernel=cuda {true:.3e}, "
        f"kernel=einsum {true_e:.3e} (ratio {true / true_e:.2f}); float32 "
        f"floor {floor:.3e} / {floor_e:.3e}; iterations {st['iters']} vs "
        f"{ste['iters']}; solution rel L2 diff {rel:.3e}")
    check(st["resnorm"] <= 1e-6 * float(torch.linalg.norm(b)) * 1.0001,
          f"{label} converged at rtol 1e-6")
    check(st["launches"] == 1,
          f"{label}: {key} launched once per element_jacobian")
    check(true <= 2.0 * true_e,
          f"{label} true residual <= 2 x the einsum float32 solve's")
    check(abs(st["iters"] - ste["iters"]) <= 0.15 * ste["iters"],
          f"{label} iterations within 15% of the einsum float32 solve")
    check(torch.equal(u, out["cuda again"][0])
          and st["iters"] == out["cuda again"][1]["iters"],
          f"{label}: two solves bit-identical")
    check(st["readbacks"] <= st["iters"] // 16 + 1,
          f"{label}: <= 1 host read-back per 16 CG iterations")
    check(bool(torch.isfinite(u).all()) and u.shape == (m.ndof,),
          f"{label} solution finite, shape (ndof,)")
    return dict(st=st, ste=ste, ej_ms=ej_ms, mem=mem, true=true,
                true_e=true_e, floor=floor, parts=parts, err=err)


TOPO_WARMUP, TOPO_ITERS = 2, 20  # bench.py --topo-iters defaults to 40


def topo_stages(dt, label, k):
    """The six stages of an MMA iteration of ``dt`` (a ``DeviceTopo``
    after its timed run), by CUDA events between its ``mark`` calls over
    three iterations from the run's end state, then one more iteration
    under the profiler.  Returns (stage -> mean ms, mean iteration ms,
    device busy % from device rows or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lb_v, ub_v = dt._init_state()[1:3]
    state = dt.state
    stage_ms, step_ms = {}, []
    for _ in range(3):
        events = []

        def record(stage):
            events.append((stage, torch.cuda.Event(enable_timing=True)))
            events[-1][1].record()

        dt.mark = record
        e0 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, _st = dt._step(*state, k, lb_v, ub_v)
        k += 1
        torch.cuda.synchronize()
        prev = e0
        for stage, e in events:
            stage_ms.setdefault(stage, []).append(prev.elapsed_time(e))
            prev = e
        step_ms.append(e0.elapsed_time(prev))
    dt.mark = None
    stages = {st_: float(np.mean(v)) for st_, v in stage_ms.items()}
    step = float(np.mean(step_ms))
    log(f"{label}: one iteration's stages (CUDA events, mean of 3): "
        + ", ".join(f"{st_} {v:.3f} ms" for st_, v in stages.items())
        + f"; whole iteration {step:.3f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dt._step(*state, k, lb_v, ub_v)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    if not rows:
        log(f"{label} profile: no device time recorded (busy share not "
            f"measured)")
        return stages, step, None
    busy_ms = sum(dev_us(r) for r in rows) / 1e3
    log(f"{label} profile: {sum(r.count for r in rows)} device activities "
        f"in one iteration, device time {busy_ms:.3f} ms = "
        f"{100 * busy_ms / step:.1f}% of the unprofiled iteration's "
        f"{step:.3f} ms")
    for r in sorted(rows, key=dev_us, reverse=True)[:8]:
        log(f"  {dev_us(r) / 1e3:9.3f} ms {r.count:6d}x  {r.key[:90]}")
    return stages, step, 100 * busy_ms / step


def phase_topo(dev, pt, i2p):
    """Phase 7: topology optimization at the width of ``bench.py --config
    topo`` (bench.py:319-428): 1025x513 quad4 cantilever, p=3,
    Chebyshev-node nu=2, bf16 smoother copy, flexible PCG rtol 1e-6,
    Helmholtz r0=0.01 rtol 1e-6, ``DeviceTopo(fixed_volume=0.4)``;
    2 warm-up and 20 timed MMA iterations (the bench's 40 cut for
    time).  Reports s/iteration, the state and filter iteration counts,
    K1/K2/K9 launches and host read-backs per iteration, the CUDA-event
    times of an iteration's six stages, the device busy share and peak
    memory, the first iteration's float32 compliance against a
    float64-outer solve, and a 4-iteration run resumed at 2 against the
    uninterrupted one."""
    import torch
    from pathlib import Path
    from pyfem_gpu_testflight_tpu_torch import solvers
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.opt import DeviceTopo

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    t0 = time.time()
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
    model.attach_structured_grid(NX, NY, nu_pre=2, nu_post=2, min_n=5,
                                 smoother_dtype=torch.bfloat16,
                                 omega="cheby")
    filtr = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float32,
                         rtol=1e-6, device=dev)
    filtr.attach_structured_grid(NX, NY)
    make = lambda: DeviceTopo(model, filtr, fixed_volume=0.4, rtol=1e-6,
                              maxiter=200)
    dt = make()
    torch.cuda.synchronize()
    log(f"topo: {model.ndof} state dof, {model.nnodes} design variables, "
        f"levels {model._gmg_asm.sizes}, set-up {time.time() - t0:.2f} s")
    t0 = time.time()
    dt.optimize(max_iterations=TOPO_WARMUP, verbose=False,
                log_every=TOPO_WARMUP)
    log(f"topo: {TOPO_WARMUP}-iteration warm-up {time.time() - t0:.2f} s")

    # the timed run: launches snapshotted at the end of every iteration
    names = ("pyfem_assemble_2d", "pyfem_smooth_2d", "pyfem_sweeps_2d",
             "pyfem_stencil_2d")
    snaps = []

    def snapshot(stage):
        if stage == "mma_update":
            snaps.append(dict({k: _cuda.launches[k] for k in names},
                              **solvers.readbacks))

    dt.mark = snapshot
    dt.history.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rb0 = dict(solvers.readbacks)
    log_every = TOPO_ITERS // 4
    _cuda.reset_launches()
    x, rho = dt.optimize(max_iterations=TOPO_ITERS, verbose=False,
                         log_every=log_every)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    dt.mark = None
    per_it = [{k: s_[k] - (snaps[i - 1][k] if i else 0) for k in names}
              for i, s_ in enumerate(snaps)]
    hist = dt.history
    cg = [h["cg_iters"] for h in hist]
    fi = [h["filter_iters"] for h in hist]
    objs = [h["obj"] for h in hist]
    # read-backs of the timed iterations: the state PCG's r.r per PCG
    # iteration, the filter's flag per 16 of its iterations, one stats
    # drain per log_every iterations
    rb = {k: snaps[-1][k] - rb0[k] for k in rb0}
    reads = rb["pcg"] + rb["cg"] + TOPO_ITERS // log_every
    log(f"topo: {TOPO_ITERS} timed MMA iterations (bench.py runs 40; cut "
        f"to {TOPO_ITERS} for the time limit) in {dt.elapsed:.3f} s, "
        f"{dt.s_per_iter:.4f} s/iteration (CUDA-synchronized; steady "
        f"{dt.steady_s_per_iter:.4f}); compliance {objs[0]:.6e} -> "
        f"{objs[-1]:.6e}, volume {float(model.volume(rho)):.5f}")
    log(f"topo: state PCG iterations {cg}")
    log(f"topo: filter PCG iterations (fwd, bwd) {fi}")
    log(f"topo: launches per iteration K1 {[p['pyfem_assemble_2d'] for p in per_it]}, "
        f"K2 {[k2_launches(p) for p in per_it]}, K9 "
        f"{[p['pyfem_stencil_2d'] for p in per_it]}")
    log(f"topo: host read-backs {reads} in {TOPO_ITERS} iterations "
        f"({reads / TOPO_ITERS:.1f} per iteration: state PCG {rb['pcg']}, "
        f"filter {rb['cg']}, drains {TOPO_ITERS // log_every}); peak "
        f"device memory {mem / 2**20:.1f} MiB above the {base / 2**20:.1f} "
        f"MiB allocated before the run")
    check(len(hist) == TOPO_ITERS and all(np.isfinite(objs))
          and all(0 < c <= 200 for c in cg), "topo: 20 iterations, finite "
          "history, every state solve converged (drain checks each)")
    check(len(per_it) == TOPO_ITERS
          and all(p["pyfem_stencil_2d"] > 0 for p in per_it)
          and all(p["pyfem_assemble_2d"] == len(model._gmg_asm.sizes)
                  for p in per_it),
          "topo: K9 launched in every iteration, K1 once per level")

    topo_stages(dt, "topo", TOPO_ITERS)

    # the first iteration's float32 compliance against a float64-outer
    # solve of the same density
    x0 = torch.full((model.nnodes,), 0.95, dtype=torch.float32, device=dev)
    rho0 = torch.clamp(filtr.apply(x0), min=dt.rho_floor)
    gmg, lv0 = model._gmg_asm.assemble(rho0)
    b = torch.where(lv0.mask, 0.0,
                    i2p(model.compute_rhs(), 2).reshape(2, NY, NX))
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho0, 3.0, dev)
    xa, ka, _ = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    c64 = float(torch.dot(b.double().reshape(-1), xa.reshape(-1)))
    log(f"topo: first iteration compliance float32 {objs[0]:.8e}, "
        f"float64-outer ({ka} iterations, true residual {true_a:.2e}) "
        f"{c64:.8e}: rel diff {abs(objs[0] - c64) / abs(c64):.3e}")
    check(true_a <= 1e-5, "topo: float64-outer true residual <= 1e-5")

    # stop at 2, resume to 4: bit for bit the uninterrupted 4 iterations
    ck = Path("build") / "chip_smoke" / "topo_checkpoint.npz"
    ck.parent.mkdir(parents=True, exist_ok=True)
    d_full = make()
    x4, _ = d_full.optimize(max_iterations=4, verbose=False, log_every=2)
    make().optimize(max_iterations=2, verbose=False, log_every=2,
                    checkpoint_path=str(ck))
    d_res = make()
    x4r, _ = d_res.optimize(max_iterations=4, verbose=False, log_every=2,
                            resume=str(ck))
    same = torch.equal(x4, x4r) and [h["obj"] for h in d_res.history] == [
        h["obj"] for h in d_full.history]
    log(f"topo: 4 iterations resumed at 2 vs uninterrupted: bit-identical "
        f"{same} (objectives {[h['obj'] for h in d_res.history]})")
    check(same, "topo: a run resumed at iteration 2 equals the "
          "uninterrupted run bit for bit")
    n_k9 = sum(p["pyfem_stencil_2d"] for p in per_it)
    return dict(s_per_iter=dt.s_per_iter, k9_launches=n_k9,
                k9_per_iter=n_k9 / TOPO_ITERS, mem=mem, cg=cg)


NEWTON_N = 1025      # bench.py --config newton: 1025^2 nodes, 1,050,625 dof
NEWTON_YARD_N = 257  # the float64 yardstick's grid (host SuperLU tangents)
# bench newton's contract (bench.py:230-260, :733-746): relative Newton
# tolerance 2e-2 on the float64 true residual, GMRES rtol 1e-2 and at most
# 40 iterations per tangent solve, at most 12 Newton iterations
NEWTON_KW = dict(tol=2e-2, atol=0.0, lin_rtol=1e-2, lin_maxiter=40,
                 max_iter=12, verbose=False)
# the 257^2 float32 fused gmg solution against the float64 direct Newton
# solution, rel L2.  Set from ``--newton-floor`` on an H100 (PERF.md
# section 2): the bench design vector reads 1.53e-3, three seeded ones
# 2.2e-4..4.1e-4, each after 5 Newton iterations
NEWTON64_TOL = 3e-3


def newton_model(pt, dev, n, dtype):
    """bench newton's model (bench.py:240-253): the creator's Poisson
    raster, ``attach_structured_grid`` with the bench's default
    Chebyshev-node damping."""
    conn, X, fixed = pt.ProblemCreator(n, n).create_poisson_problem()
    m = pt.NonlinearPoisson("quad4", X, conn, fixed, dtype=dtype, device=dev)
    return m.attach_structured_grid(n, n, omega="cheby")


def newton_yardstick(dev, pt, xdv):
    """The float32 fused gmg Newton at the bench contract against a
    float64 ``solve_nonlinear(method="direct")`` (host SuperLU tangents,
    tol 1e-10) at NEWTON_YARD_N^2: (rel L2 difference, Newton iterations
    of each)."""
    import torch

    n = NEWTON_YARD_N
    m64 = newton_model(pt, dev, n, torch.float64)
    u64 = m64.solve_nonlinear(method="direct", xdv=xdv, tol=1e-10,
                              verbose=False)
    m32 = newton_model(pt, dev, n, torch.float32)
    u32, k32, _rn = m32.solve_nonlinear_fused(method="gmg", xdv=xdv,
                                              **NEWTON_KW)
    err = float(torch.linalg.norm(u32.double() - u64)
                / torch.linalg.norm(u64))
    return err, k32


def run_newton_floor():
    """``python3 chip_smoke.py --newton-floor``: the 257^2 yardstick of
    phase 8 on the bench design vector and three seeded ones, the
    readings ``NEWTON64_TOL`` is set from; prints the card and one JSON
    line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt

    log(card_line())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED + 8)
    out = {}
    for name, xdv in [("bench", np.ones(10) / 10)] + [
            (f"seed{s}", rng.uniform(0.0, 1.0, 10)) for s in (1, 2, 3)]:
        err, k = newton_yardstick(dev, pt, xdv)
        log(f"newton yardstick {name}: rel L2 {err:.3e}, {k} Newton "
            f"iterations (float32 fused gmg)")
        out[name] = err
    log(json.dumps({"newton_rel_l2": out}))
    return 0


def run_newton():
    """``python3 chip_smoke.py --newton``: only phase 8 (with the kernel
    build); prints the card and one JSON line of its kernel rows."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    out = phase_newton(torch.device("cuda", 0), pt)
    log(json.dumps({"newton_kernels": out["kernels"],
                    "launches": out["counts"], "k9": out["k9"]}))
    return 1 if FAILS else 0


def phase_newton(dev, pt):
    """Phase 8: ``bench.py --config newton`` (bench.py:213-316) on the
    card: ``NonlinearPoisson("quad4", float32)`` on the 1025^2 creator
    raster, ``attach_structured_grid`` (Chebyshev-node damping, the
    bench's default), ``solve_nonlinear_fused(method="gmg", xdv=1/10,
    tol=2e-2, atol=0, lin_rtol=1e-2, lin_maxiter=40, max_iter=12)``.
    Checks convergence (<= 12 Newton iterations, the float64 true
    residual ratio <= 2e-2), the kernels launched on the path (K1 once
    per level per tangent solve, K2, K9 in float32 and float64) and K1,
    K2 and K9 against their plain versions on the path's own inputs;
    times single-shot (median of 3) and chained (depth 4 against 12, u0
    = 0 * u_prev as bench.py:276-303), splits a Newton iteration into its
    stages (CUDA events through the model's ``mark`` hook), and reads the
    busy share, the peak memory and the float64 yardstick at 257^2."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pyfem_gpu_testflight_tpu_torch import solvers
    from pyfem_gpu_testflight_tpu_torch.models.nonlinear_poisson import hfunc
    from pyfem_gpu_testflight_tpu_torch.multigrid import (
        _restrict_nodal, smoothing_omegas,
    )
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    n = NEWTON_N
    t0 = time.time()
    model = newton_model(pt, dev, n, torch.float32)
    asm = model._gmg_newton
    nlev = len(asm.static_levels)
    xdv = torch.full((10,), 0.1, dtype=torch.float32, device=dev)
    solve = lambda u0: model.solve_nonlinear_fused(method="gmg", xdv=xdv,
                                                   u0=u0, **NEWTON_KW)
    torch.cuda.synchronize()
    log(f"newton: {model.ndof} dof, float32, levels {asm.sizes}, set-up "
        f"{time.time() - t0:.2f} s")
    t0 = time.time()
    u, k, rn = solve(None)
    torch.cuda.synchronize()
    log(f"newton: first (cold) solve {time.time() - t0:.3f} s host clock")

    # the counted run: every count zeroed just before, read just after;
    # K9's two forms told apart by its float64 flag
    names = ("pyfem_assemble_2d", "pyfem_smooth_2d", "pyfem_sweeps_2d",
             "pyfem_stencil_2d", "pyfem_assemble_2d_sym",
             "pyfem_smooth_2d_sym", "pyfem_sweeps_2d_sym")
    k9 = {0: 0, 1: 0}
    launch = _cuda.launch

    def counting(name, *a):
        launch(name, *a)
        if name == "pyfem_stencil_2d":
            k9[int(a[6])] += 1

    rb0 = dict(solvers.readbacks)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _cuda.reset_launches()
    _cuda.launch = counting
    try:
        e0.record()
        u, k, rn = solve(0.0 * u)
        e1.record()
        e1.synchronize()
    finally:
        _cuda.launch = launch
    counts = {name: _cuda.launches[name] for name in names}
    counts["K2"] = k2_launches(counts)
    single0 = e0.elapsed_time(e1)
    st = dict(model.last_solve_stats)
    rb = {key: solvers.readbacks[key] - rb0[key] for key in rb0}
    ratio = st["resnorms"][-1] / st["resnorms"][0]
    r_end = float(model._uniform_residual_f64(xdv, u)[1])
    r_0 = float(model._uniform_residual_f64(xdv, torch.zeros_like(u))[1])
    log(f"newton: {k} Newton iterations, GMRES iterations per tangent "
        f"solve {st['lin_iters']}, float64 residual norms "
        f"{['%.4e' % v for v in st['resnorms']]}; true residual ratio "
        f"{ratio:.4e} (recomputed {r_end / r_0:.4e}); read-backs: Newton "
        f"{rb['newton']}, GMRES {rb['gmres']}; launches {counts}, K9 "
        f"float32 {k9[0]}, float64 {k9[1]}; {single0:.1f} ms")
    check(k <= 12 and bool(torch.isfinite(u).all())
          and u.shape == (model.ndof,), "newton: converged within 12 "
          "Newton iterations, solution finite, shape (ndof,)")
    check(ratio <= 2e-2 and r_end / r_0 <= 2e-2,
          "newton: float64 true residual ratio <= 2e-2")
    check(counts["pyfem_assemble_2d"] == nlev * (k - 1)
          and counts["K2"] > 0 and k9[0] > 0 and k9[1] == k
          and counts["pyfem_assemble_2d_sym"] == 0
          and k2_sym_launches(counts) == 0,
          f"newton: K1 once per level ({nlev}) per tangent solve, K2 "
          f"launched, K9 float32 launched and float64 once per Newton "
          f"iteration, no half-storage launch")
    calls, nk2 = k2_per_call(lambda: solve(0.0 * u))
    log(f"newton: {calls} smoothing calls, {nk2} K2 launches")
    check(calls > 0 and nk2 == calls,
          f"newton: one K2 launch per smoothing call ({calls})")

    # K1, K2, K9 against their plain versions on the path's inputs: the
    # iterate's coefficient field on every level, the finest level's
    # smoothing call on its residual, the eliminated nonsymmetric tangent
    # planes and the float64 flux
    res = {}
    mask0 = asm.static_levels[0].mask
    c = (hfunc(xdv, model.X) * (1.0 + u * u)).reshape(n, n).contiguous()
    log(f"newton: coefficient field c = h(1+u^2) in [{float(c.min()):.4f}, "
        f"{float(c.max()):.4f}]")
    rho, worst, k2_abs = c, 0.0, 0.0
    rng = np.random.default_rng(SEED + 80)
    for lv, stl in enumerate(asm.static_levels):
        args = (rho, stl.maskf, stl.W, asm.N)
        kw = dict(nd=1, p=0.0)
        got = fa.assemble_pack_2d(*args, **kw)
        ref = fa.assemble_pack_2d_plain(*args, **kw)
        torch.cuda.synchronize()
        free = stl.maskf > 0
        (ea, er), (ia, ir) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1],
                                                               free)
        worst = max(worst, ea, ia)
        check(er <= REL_TOL and ir <= REL_TOL
              and bool((got[1][~free] == 0).all()),
              f"newton K1 level {stl.shape[1]}x{stl.shape[0]} on c: planes "
              f"rel {er:.2e}, inv_diag rel {ir:.2e} within {REL_TOL:g}")
        # K2's newton call forms on this level's planes, seeded fields
        field = lambda: torch.where(stl.mask, 0.0, torch.as_tensor(
            rng.standard_normal((1,) + tuple(rho.shape)),
            dtype=torch.float32, device=dev))
        rows, _w = k2_level_rows(
            got[0], got[1], None, field(), field(), None,
            f"newton level {rho.shape[1]}x{rho.shape[0]} nd=1",
            forms=("presmooth_resid_f32", "postsmooth_f32"))
        k2_abs = max([k2_abs] + [v["max_abs_err"] for v in rows.values()])
        if lv == 0:
            b_ms, b_by = bound(nbytes(*args, *got), k1_flops(1, False,
                                                            rho.numel()))
            res["K1"] = dict(ms=cuda_ms(lambda: fa.assemble_pack_2d(
                *args, **kw), 50), device_ms=device_ms(
                lambda: fa.assemble_pack_2d(*args, **kw)),
                plain_ms=cuda_ms(lambda: fa.assemble_pack_2d_plain(
                    *args, **kw), 10), bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
            fine = got
        rho = _restrict_nodal(rho)
    res["K1"]["max_abs_err"] = worst

    r32, _ = model._uniform_residual_f64(xdv, u)
    b = torch.where(mask0, 0.0, r32.reshape(1, n, n))
    ck, dk = fine[0], fine[1]
    worst = 0.0
    om = smoothing_omegas(2, asm.cheb_lam, asm.cheb_frac)
    for name, (a, kw) in {
            "presmooth_resid": ((ck, dk, b, None),
                                dict(niter=2, want_resid=True, omega=om)),
            "matvec": ((ck, dk, None, b),
                       dict(niter=0, want_resid=True, neg_resid=True))
    }.items():
        got = fs.fused_sweeps_2d(*a, **kw)
        ref = fs.fused_sweeps_2d_plain(*a, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        worst = max([worst] + [e[0] for e in errs])
        check(all(e[1] <= REL_TOL for e in errs),
              f"newton K2 {name} nd=1 {n}x{n} within {REL_TOL:g} (rel "
              + ", ".join(f"{e[1]:.2e}" for e in errs) + ")")
        if name == "matvec":
            b_ms, b_by = bound(nbytes(ck, b) + nbytes(b), 2 * 9 * n * n)
            flush = l2_flush(dev)
            res["K2"] = dict(
                flushed_times(lambda: fs.fused_sweeps_2d(*a, **kw), flush),
                plain_ms=cuda_ms(lambda: fs.fused_sweeps_2d_plain(*a, **kw),
                                 10), bound_ms=b_ms, bound_by=b_by,
                library_ms=library_matvec_ms(ck.reshape(1, 1, 3, 3, n, n),
                                             (n, n), b))
            del flush
    res["K2"]["max_abs_err"] = max(worst, k2_abs)

    cs, cr = model._uniform_tangent_coeffs(xdv, u.reshape(n, n))
    ce = asm.static_levels[0].op.bc_eliminate(cs + cr, mask0)
    asym = float((ce[0, 0, 1, 2, :, :-1] - ce[0, 0, 1, 0, :, 1:]).abs().max())
    log(f"newton: tangent planes nonsymmetric by {asym:.3e} (east vs the "
        f"east neighbour's west coefficient)")
    check(asym > 0, "newton: the eliminated tangent planes are nonsymmetric")
    for name, (cc, v) in (("nd1_f32_tangent", (ce, b)),
                          ("nd1_f64_flux", (cs.double(),
                                            u.double().reshape(1, n, n)))):
        got = sm.stencil_matvec_2d(cc, v)
        ref = sm.stencil_matvec_2d_plain(cc, v)
        torch.cuda.synchronize()
        ea, er = rel_err(got, ref)
        check(er <= REL_TOL and got.dtype == v.dtype,
              f"newton K9 {name} {n}x{n} within {REL_TOL:g} (rel {er:.2e})")
        f64 = v.dtype == torch.float64
        b_ms, b_by = bound(nbytes(cc, v, got), 2 * 9 * n * n,
                           F64_FLOP_S if f64 else F32_FLOP_S)
        flush = l2_flush(dev)
        res[f"K9 {name}"] = dict(
            flushed_times(lambda: sm.stencil_matvec_2d(cc, v), flush),
            max_abs_err=ea,
            plain_ms=cuda_ms(lambda: sm.stencil_matvec_2d_plain(cc, v), 10),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=library_matvec_ms(cc, (n, n), v, dtype=v.dtype))
        del flush
    for key, r in res.items():
        warm = ("" if "l2_warm_ms" not in r else
                f"; L2 flushed before each call; back to back "
                f"{r['l2_warm_ms']:.4f}, device "
                f"{fms(r['l2_warm_device_ms'])}")
        log(f"newton {key} nd=1 {n}x{n}: kernel {r['ms']:.4f} ms (device "
            f"{fms(r['device_ms'])}{warm}), plain {r['plain_ms']:.4f} ms, "
            f"bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), one-call PyTorch "
            + ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms"))
    del cs, cr, ce, fine, ck, dk

    # times: single-shot (median of 3) and chained, u0 = 0 * u_prev
    singles = []
    for _ in range(3):
        e0.record()
        u, k, rn = solve(0.0 * u)
        e1.record()
        e1.synchronize()
        singles.append(e0.elapsed_time(e1))
    single = float(np.median(singles))

    def chained(depth):
        nonlocal u
        e0.record()
        for _ in range(depth):
            u = solve(0.0 * u)[0]
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1)

    t4, t12 = chained(4), chained(12)
    ch = (t12 - t4) / 8
    log(f"newton: single-shot {['%.1f' % v for v in singles]} ms (median "
        f"{single:.1f}); chained depth 4 {t4:.1f} ms, 12 {t12:.1f} ms: "
        f"{ch:.1f} ms/solve")

    # one solve's Newton iterations split by stage (CUDA events)
    events = []

    def mark(stage):
        events.append((stage, torch.cuda.Event(enable_timing=True)))
        events[-1][1].record()

    model.mark = mark
    rb0 = dict(solvers.readbacks)
    e0.record()
    u, k, rn = solve(0.0 * u)
    torch.cuda.synchronize()
    model.mark = None
    rbs = {key: solvers.readbacks[key] - rb0[key] for key in rb0}
    per_it, prev, cur = [], e0, {}
    for stage, ev in events:
        cur[stage] = prev.elapsed_time(ev)
        prev = ev
        if stage in ("update",):
            per_it.append(cur)
            cur = {}
    per_it.append(cur)  # the converged iteration: its residual only
    lin = model.last_solve_stats["lin_iters"]
    for i, d in enumerate(per_it):
        log(f"newton iteration {i}: " + ", ".join(
            f"{s_} {v:.2f} ms" for s_, v in d.items())
            + (f" ({lin[i]} GMRES iterations)" if i < len(lin) else ""))
    tot = {s_: sum(d.get(s_, 0.0) for d in per_it)
           for s_ in ("residual", "tangent", "hierarchy", "gmres", "update")}
    whole = sum(tot.values())
    log(f"newton stages of one solve ({k} iterations, {sum(lin)} GMRES "
        f"iterations, read-backs {rbs['newton']} Newton + {rbs['gmres']} "
        f"GMRES): " + ", ".join(f"{s_} {v:.1f} ms ({100 * v / whole:.1f}%)"
                               for s_, v in tot.items())
        + f"; per GMRES iteration {tot['gmres'] / max(sum(lin), 1):.2f} ms")

    # busy share and peak memory of one solve
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        u, k, rn = solve(0.0 * u)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy_ms = sum(dev_us(r) for r in rows) / 1e3
    if rows:
        DEVICE_MS["newton"] = busy_ms
        log(f"newton profile: {sum(r.count for r in rows)} device activities "
            f"in one solve, device time {busy_ms:.3f} ms = "
            f"{100 * busy_ms / single:.1f}% of the unprofiled single-shot "
            f"{single:.1f} ms")
        for r in sorted(rows, key=dev_us, reverse=True)[:8]:
            log(f"  {dev_us(r) / 1e3:9.3f} ms {r.count:6d}x  {r.key[:90]}")
        # the port's kernels by symbol, as the profiler names them
        for sym in ("assemble_2d", "smooth_2d_kernel",
                    "stencil_2d_kernel<1, float>",
                    "stencil_2d_kernel<1, double>"):
            hit = [r for r in rows if sym in r.key]
            log(f"newton profile: {sym}: {sum(r.count for r in hit)} "
                f"launches, {sum(dev_us(r) for r in hit) / 1e3:.3f} ms")
    else:
        log("newton profile: no device time recorded (busy share not "
            "measured)")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    u, k, rn = solve(0.0 * u)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    log(f"newton: peak device memory of one solve {mem / 2**20:.1f} MiB "
        f"above the {base / 2**20:.1f} MiB allocated before it")

    # the float64 yardstick at 257^2
    t0 = time.time()
    err, k32 = newton_yardstick(dev, pt, np.ones(10) / 10)
    log(f"newton yardstick {NEWTON_YARD_N}x{NEWTON_YARD_N}: float32 fused "
        f"gmg ({k32} Newton iterations) vs float64 direct Newton: rel L2 "
        f"{err:.3e} ({time.time() - t0:.1f} s)")
    check(err <= NEWTON64_TOL, f"newton: the {NEWTON_YARD_N}^2 float32 "
          f"solution within {NEWTON64_TOL:g} (rel L2) of the float64 one")
    return dict(kernels=res, counts=counts, k9=k9, k=k, single=single,
                ch=ch, mem=mem, ratio=ratio)


QUAD_N = 65       # bench.py --config quadratic: --n3d-quad 65, brick20
QUAD_TET_N = 33   # the tet10 line: 33^3 (65^3 has 196,608 elements; cut)
QUAD_RTOL = 1e-6  # bench.py's --rtol default
# the JAX bench run (BENCH_r05.json, quadratic): 411,840 live dof of the
# 65^3 lattice, 32,768 elements, 10 PCG iterations, cheb_lam 5.100
QUAD_LIVE_DOF, QUAD_ELEMS = 411_840, 32_768
QUAD_MAX_ITERS = 12
QUAD_CHEB_LAM = 5.100
# bench quadratic's float32 solution against the float64-outer solution
# of the same system (flexible PCG, rtol 1e-10, the float32 PMG
# preconditioner through casts), max-abs of max.  Set from
# ``--quadratic-floor`` on an H100 (PERF.md section 2): the bench load
# reads 1.52e-3, three seeded standard-normal loads 1.86e-3..2.78e-3
PMG64_TOL = 4e-3


def quadratic_model(pt, dev, et, n, dtype=None, kernel="einsum", pmg=True,
                    **pmg_options):
    """bench quadratic's model (bench.py:147-157): the creator's
    elasticity problem on the n^3 ``et`` lattice ("brick20" or "tet"),
    p = 0, ``attach_pmg(n, n, n)`` unless ``pmg`` is False."""
    import torch

    c = pt.ProblemCreator(n, n, n, element_type=et)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    m = pt.LinearElasticity("tet10" if et == "tet" else "brick20", X, conn,
                            fixed, None, force, p=0.0,
                            dtype=torch.float32 if dtype is None else dtype,
                            device=dev, kernel=kernel)
    return m.attach_pmg(n, n, n, **pmg_options) if pmg else m


def pmg_f64_operator(pt, dev, et, n, pmg, rho):
    """(A., |A|.): the float64 lattice operator of ``pmg``'s system and
    its absolute value (the float32 floor), from a float64 twin model's
    element matrices (einsum)."""
    import torch

    m64 = quadratic_model(pt, dev, et, n, torch.float64, pmg=False)
    Ke64 = m64.element_jacobian(rho.double())
    Kabs = Ke64.abs()
    del m64
    return (lambda v: pmg._afree(Ke64, v)), (lambda v: pmg._afree(Kabs, v))


def pmg_outer64(pmg, mv64, rho, b, rtol=1e-10):
    """float64 flexible PCG on ``mv64``, the float32 PMG preconditioner
    of ``rho`` through casts: (x64, iterations)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid

    _afree, pre32 = pmg.operators(rho)
    pre = lambda r: pre32(r.to(torch.float32)).to(torch.float64)
    x, k, _rn = multigrid.pcg(mv64, pre, b.to(torch.float64), rtol=rtol,
                              maxiter=200, flexible=True)
    return x, k


def quadratic_floor(dev, pt, seeds=(1, 2, 3)):
    """bench quadratic's float32 solution against the float64-outer one,
    max-abs of max, on the bench load and on seeded standard-normal
    loads (zero at fixed and dead dofs): {load: reading}."""
    import torch

    m = quadratic_model(pt, dev, "brick20", QUAD_N)
    pmg = m._pmg
    rho = torch.ones(m.nnodes, dtype=torch.float32, device=dev)
    mv64, _ = pmg_f64_operator(pt, dev, "brick20", QUAD_N, pmg, rho)
    loads = [("bench", m.compute_rhs())] + [
        (f"seed{s}", torch.as_tensor(np.random.default_rng(s).standard_normal(
            m.ndof), dtype=torch.float32, device=dev)) for s in seeds]
    out = {}
    for name, rhs in loads:
        x32, b, k, _rn = pmg.solve(rho=rho, rhs=rhs, rtol=QUAD_RTOL)
        x64, k64 = pmg_outer64(pmg, mv64, rho, b)
        out[name] = float((x32.double() - x64).abs().max() / x64.abs().max())
        log(f"quadratic floor {name}: float32 solution vs float64-outer "
            f"{out[name]:.3e} (max-abs of max; {k} / {k64} PCG iterations)")
    return out


def run_quadratic_floor():
    """``python3 chip_smoke.py --quadratic-floor``: the readings
    ``PMG64_TOL`` is set from; prints the card and one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    _cuda.library()
    out = quadratic_floor(torch.device("cuda", 0), pt)
    log(json.dumps({"pmg64_readings": out}))
    return 0


def run_quadratic():
    """``python3 chip_smoke.py --quadratic``: only phase 9 (with the
    kernel build); prints the card and one JSON line of its launches."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    out = phase_quadratic(torch.device("cuda", 0), pt)
    log(json.dumps({"quadratic_launches": out["launches"],
                    "quadratic_kernels": out["kernels"]}))
    return 1 if FAILS else 0


# the kernels on phase 9's path, by the entry point each launches
_QUAD_ENTRY = {"K3": "pyfem_assemble_3d", "K4": "pyfem_sweep_3d",
               "K5": "pyfem_sweeps_3d", "K8": "pyfem_stiffness_3d"}


def quadratic_line(dev, pt, label, model, rho):
    """One p-multigrid line through the user's entry point: a cold solve
    (it measures ``cheb_lam``), then ``model.solve(method="pmg")`` with
    the counts zeroed just before and read just after; returns (u, b,
    iterations, resnorm, counts, ms)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    t0 = time.time()
    model.solve(method="pmg", rho=rho, rtol=QUAD_RTOL)
    torch.cuda.synchronize()
    log(f"{label}: first (cold) solve {time.time() - t0:.3f} s host clock, "
        f"cheb_lam {model._pmg._cheb_lam:.4f}")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _cuda.reset_launches()
    e0.record()
    u = model.solve(method="pmg", rho=rho, rtol=QUAD_RTOL)
    e1.record()
    e1.synchronize()
    counts = {k: _cuda.launches[k] for k in _QUAD_ENTRY.values()}
    st = model.last_solve_stats
    b = torch.where(model._pmg.mask_all, 0.0, model.compute_rhs())
    bn = float(torch.linalg.norm(b))
    log(f"{label}: {st['iters']} PCG iterations, ||r||/||b|| "
        f"{st['resnorm'] / bn:.3e}, launches {counts}, "
        f"{e0.elapsed_time(e1):.1f} ms")
    check(st["resnorm"] <= QUAD_RTOL * bn and bool(torch.isfinite(u).all())
          and u.shape == (model.ndof,),
          f"{label}: PCG residual <= rtol, solution finite, shape (ndof,)")
    return u, b, st["iters"], counts, e0.elapsed_time(e1)


def single_and_chained(pmg, rho, x):
    """bench.py:173-196 with CUDA events: single-shot (median of 3 after
    the warm-up solves) and chained ((depth 12 - depth 4) / 8), each
    solve's density formally dependent on the previous solution."""
    import torch

    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def chained(x):
        return pmg.solve(rho=rho + 0.0 * x[0], rtol=QUAD_RTOL)[0]

    singles = []
    for _ in range(3):
        e0.record()
        x = chained(x)
        e1.record()
        e1.synchronize()
        singles.append(e0.elapsed_time(e1))
    runs = {}
    for depth in (4, 12):
        e0.record()
        for _ in range(depth):
            x = chained(x)
        e1.record()
        e1.synchronize()
        runs[depth] = e0.elapsed_time(e1)
    return singles, float(np.median(singles)), (runs[12] - runs[4]) / 8


def solve_split(pmg, rho, b, reps=3):
    """One solve split by CUDA events into its set-up (``operators``:
    element matrices, inverse diagonal, corner hierarchy) and its PCG,
    ``reps`` times: [(set-up ms, PCG ms, iterations)]."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    out = []
    for _ in range(reps):
        ev[0].record()
        afree, precond = pmg.operators(rho)
        ev[1].record()
        _x, k, _rn = multigrid.pcg(afree, precond, b, rtol=QUAD_RTOL,
                                   flexible=True)
        ev[2].record()
        ev[2].synchronize()
        out.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]), k))
    return out


def phase_quadratic(dev, pt):
    """Phase 9: ``bench.py --config quadratic`` (bench.py:134-212) on the
    card: brick20 p-multigrid elasticity on the 65^3 lattice (411,840
    live dof), float32, rho = 1, p = 0, rtol 1e-6, ``kernel="einsum"``
    (the bench's), ``attach_pmg(65, 65, 65)``.  Checks the live dof and
    element counts, <= 12 PCG iterations, cheb_lam within 2% of the JAX
    run's 5.100, the recursive residual, the float64 true residual
    within 4x its float32 floor and the solution within ``PMG64_TOL`` of
    the float64-outer solve; holds K3 on every corner level and K5 on
    the finest against their plain versions on the path's inputs; times
    single-shot and chained solves, the stages of a solve and the
    lattice matvec against its bytes bound and the generic route; reads
    the busy share, the peak memory and the launches by level.  Then
    the ``kernel="cuda"`` line (K8, its Ke against the einsum Ke), the
    tet10 line at 33^3 (the 6-class lattice) and the Chebyshev corner
    smoother line (``gmg_options=dict(smoother="chebyshev")``: K4)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.multigrid import _restrict_nodal
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar

    def timed(fn, reps=5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        fn()
        e0.record()
        for _ in range(reps):
            out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1) / reps

    n = QUAD_N
    t0 = time.time()
    model = quadratic_model(pt, dev, "brick20", n)
    pmg = model._pmg
    live = int((~pmg.mask_all).sum())
    torch.cuda.synchronize()
    log(f"quadratic: brick20 {n}^3 lattice, {model.nelems} elements, {live} "
        f"live dof ({model.ndof} lattice dof), float32, corner levels "
        f"{pmg.asm.sizes}, set-up {time.time() - t0:.2f} s")
    check(live == QUAD_LIVE_DOF and model.nelems == QUAD_ELEMS,
          f"quadratic: {QUAD_LIVE_DOF} live dof and {QUAD_ELEMS} elements "
          f"(the JAX bench's counts)")
    check(pmg._lat_off is not None, "quadratic: the lattice route is taken")
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    label = f"quadratic brick20 {n}^3"
    u, b, k, counts, _ms = quadratic_line(dev, pt, label, model, rho)
    lam = pmg._cheb_lam
    nlev = len(pmg.asm.sizes)
    log(f"{label}: {k} PCG iterations (JAX bench run: 10), cheb_lam "
        f"{lam:.4f} (JAX bench run: {QUAD_CHEB_LAM})")
    check(k <= QUAD_MAX_ITERS, f"{label}: <= {QUAD_MAX_ITERS} PCG iterations")
    check(abs(lam - QUAD_CHEB_LAM) <= 0.02 * QUAD_CHEB_LAM,
          f"{label}: cheb_lam within 2% of {QUAD_CHEB_LAM}")
    check(counts["pyfem_assemble_3d"] == nlev
          and counts["pyfem_sweeps_3d"] > 0
          and counts["pyfem_stiffness_3d"] == 0,
          f"{label}: K3 once per corner level ({nlev}), K5 launched, no K8 "
          f"(einsum element matrices)")
    step = lambda rho: model.solve(method="pmg", rho=rho, rtol=QUAD_RTOL)
    by_level = launches_by_level(step, (rho,))
    log(f"{label}: launches by entry point and corner level (nz: count) "
        f"{by_level}")

    # float64 true residual, float32 floor and the float64-outer solve
    mv64, mvabs = pmg_f64_operator(pt, dev, "brick20", n, pmg, rho)
    true, floor = residuals(mv64, mvabs, b, u)
    log(f"{label}: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f})")
    check(true <= FLOOR_FACTOR * floor,
          f"{label}: true residual <= {FLOOR_FACTOR:g} x float32 floor")
    x64, k64 = pmg_outer64(pmg, mv64, rho, b)
    true64, _ = residuals(mv64, mvabs, b, x64)
    err64 = float((u.double() - x64).abs().max() / x64.abs().max())
    log(f"{label}: float64-outer flexible PCG (float32 PMG preconditioner): "
        f"{k64} iterations, true residual {true64:.3e}; the float32 "
        f"solution's max-abs error against it {err64:.3e} of max")
    check(true64 <= 1e-5, f"{label}: float64-outer true residual <= 1e-5")
    check(err64 <= PMG64_TOL, f"{label}: float32 solution within "
          f"{PMG64_TOL:g} of the float64-outer solution")
    del mv64, mvabs, x64

    # K3 on every corner level, K5 on the finest, against plain
    asm, res, worst3 = pmg.asm, {}, 0.0
    rho_c = rho.reshape(pmg.shape)[::2, ::2, ::2].contiguous()
    rl = rho_c
    for li, st in enumerate(asm.static_levels):
        args, kw = (rl, st.maskf, st.W, asm.N), dict(nd=3, p=0.0, sym=True)
        got = fa.assemble_pack_3d(*args, **kw)
        ref = fa.assemble_pack_3d_plain(*args, **kw)
        torch.cuda.synchronize()
        free = st.maskf > 0
        (ea, er), (ia, ir) = rel_err(got[0], ref[0]), rel_err(got[1], ref[1],
                                                               free)
        worst3 = max(worst3, ea, ia)
        check(er <= REL_TOL and ir <= REL_TOL,
              f"{label} K3 corner level {st.shape[0]}^3: planes rel "
              f"{er:.2e}, inv_diag rel {ir:.2e} within {REL_TOL:g}")
        if li == 0:
            lv0 = got
        rl = _restrict_nodal(rl)
    res["K3"] = dict(max_abs_err=worst3)
    rg = interleave_to_planar(b, 3).reshape((3,) + pmg.shape)
    bc = multigrid.restrict3d_il(rg, pmg.cshape)
    bc = torch.where(asm.static_levels[0].mask, 0.0, bc).contiguous()
    om = fs._omega_seq(asm.omega, 2)
    a5 = (lv0[0], lv0[1], bc, None)
    kw5 = dict(niter=2, want_resid=True, omega=om)
    got = fs.fused_sweeps3d(*a5, **kw5)
    ref = fs.fused_sweeps3d_plain(*a5, **kw5)
    torch.cuda.synchronize()
    errs = [rel_err(g, r) for g, r in zip(got, ref)]
    check(all(e[1] <= REL_TOL for e in errs),
          f"{label} K5 presmooth+resid on the {pmg.cshape[0]}^3 corner "
          f"level within {REL_TOL:g} (rel "
          + ", ".join(f"{e[1]:.2e}" for e in errs) + ")")
    res["K5"] = dict(max_abs_err=max(e[0] for e in errs))

    # the lattice matvec: time against its bytes bound and the generic
    # segment-sum route on the same Ke, agreeing to rounding
    Ke = model.element_jacobian(rho)
    v = torch.as_tensor(np.random.default_rng(SEED + 9).standard_normal(
        model.ndof), dtype=torch.float32, device=dev)
    y_lat = pmg._lattice_matvec(Ke, v)
    y_gen = model.matvec(Ke, v)
    ea, er = rel_err(y_lat, y_gen)
    check(er <= REL_TOL and torch.equal(y_lat, pmg._lattice_matvec(Ke, v)),
          f"{label}: lattice matvec within {REL_TOL:g} of the generic "
          f"route (rel {er:.2e}), bit-identical across two applies")
    ue = v[model.conn_dof].unsqueeze(-1)
    lat_ms = cuda_ms(lambda: pmg._lattice_matvec(Ke, v), 20)
    gen_ms = cuda_ms(lambda: model.matvec(Ke, v), 20)
    bmm_ms = cuda_ms(lambda: torch.bmm(Ke, ue), 20)
    lat_dev = device_ms(lambda: pmg._lattice_matvec(Ke, v))
    m = Ke.shape[1]
    lb_ms, lb_by = bound(nbytes(Ke, v, y_lat), 2 * Ke.shape[0] * m * m)
    log(f"{label}: lattice matvec {lat_ms:.4f} ms (device ms "
        f"{fms(lat_dev)}; of it the batched Ke @ ue {bmm_ms:.4f} ms), "
        f"bound {lb_ms:.4f} ms ({lb_by}; Ke {nbytes(Ke) / 1e6:.1f} MB), "
        f"generic gather + segment sum {gen_ms:.4f} ms")
    del y_gen, ue

    # stages of one solve (CUDA events, each piece on its own)
    inv = pmg._inv_diag(Ke)
    r0 = b.clone()
    st_ms = {}
    _, st_ms["element_jacobian"] = timed(lambda: model.element_jacobian(rho))
    _, st_ms["inv_diag"] = timed(lambda: pmg._inv_diag(Ke))
    _, st_ms["corner hierarchy"] = timed(lambda: asm.assemble(rho_c))
    _, st_ms["operators (all set-up)"] = timed(lambda: pmg.operators(rho))
    _, st_ms["power_lam (first solve only)"] = timed(
        lambda: pmg._power_lam(Ke, inv), 1)
    gmg, clv0 = asm.assemble(rho_c)
    afree, precond = pmg.operators(rho)
    _, st_ms["fine operator apply"] = timed(lambda: afree(r0), 20)
    z, st_ms["pre-Chebyshev leg (nu - 1 applies)"] = timed(
        lambda: pmg._cheb(Ke, inv, lam, None, r0, pmg.nu))
    _, st_ms["post-Chebyshev leg (nu applies)"] = timed(
        lambda: pmg._cheb(Ke, inv, lam, z, r0, pmg.nu))
    _, st_ms["corner V-cycle"] = timed(lambda: gmg.apply(bc))
    _, st_ms["transfers (restrict + prolong)"] = timed(
        lambda: multigrid.prolong3d_il(multigrid.restrict3d_il(
            rg, pmg.cshape), pmg.shape))
    _, st_ms["preconditioner"] = timed(lambda: precond(r0))
    log(f"{label} stages (CUDA events, ms): " + ", ".join(
        f"{s_} {v_:.3f}" for s_, v_ in st_ms.items())
        + f"; a PCG iteration is {2 * (pmg.nu - 1) + 3} fine applies "
        f"({pmg.nu - 1} + 1 + {pmg.nu} in the preconditioner, 1 PCG "
        f"product), one corner V-cycle and the r.r read-back")
    del Ke, inv, gmg, clv0, afree, precond

    singles, single, ch = single_and_chained(pmg, rho, u)
    log(f"{label}: single-shot {['%.1f' % s_ for s_ in singles]} ms (median "
        f"{single:.1f}); chained {ch:.1f} ms/solve")
    split = solve_split(pmg, rho, b)
    log(f"{label}: a solve split (set-up ms, PCG ms, iterations): "
        + ", ".join(f"({a_:.1f}, {p_:.1f}, {k_})" for a_, p_, k_ in split))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pmg.solve(rho=rho, rtol=QUAD_RTOL)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy = None
    if rows:
        busy = sum(dev_us(r) for r in rows) / 1e3
        DEVICE_MS["quadratic"] = busy
        every = sum(dev_us(r) for r in prof.key_averages()) / 1e3
        log(f"{label} profile: {sum(r.count for r in rows)} device "
            f"activities in one solve, device time {busy:.3f} ms = "
            f"{100 * busy / single:.1f}% of the unprofiled single-shot "
            f"{single:.1f} ms (the sum over every profiler row, operators' "
            f"rows repeating their kernels: {every:.3f} ms)")
        for r in sorted(rows, key=dev_us, reverse=True)[:8]:
            log(f"  {dev_us(r) / 1e3:9.3f} ms {r.count:6d}x  {r.key[:90]}")
    else:
        log(f"{label} profile: no device time recorded (busy share not "
            f"measured)")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pmg.solve(rho=rho, rtol=QUAD_RTOL)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    log(f"{label}: peak device memory of one solve {mem / 2**20:.1f} MiB "
        f"above the {base / 2**20:.1f} MiB allocated before it")
    launches = {"brick20": counts}
    out = dict(k=k, lam=lam, single=single, ch=ch, mem=mem, busy=busy,
               err64=err64, true=true, floor=floor, by_level=by_level)

    # the Chebyshev corner smoother on the same model: K4 residual passes
    model.attach_pmg(n, n, n, gmg_options=dict(smoother="chebyshev"))
    lab = f"quadratic brick20 {n}^3, corner smoother chebyshev"
    _u, _b, kc, cc, _ms = quadratic_line(dev, pt, lab, model, rho)
    check(cc["pyfem_sweep_3d"] > 0 and cc["pyfem_sweeps_3d"] == 0
          and cc["pyfem_assemble_3d"] == nlev,
          f"{lab}: K3 once per corner level, K4 launched, no K5")
    lvc = model._pmg.asm.assemble(rho_c)[1]
    x = torch.as_tensor(np.random.default_rng(SEED + 10).standard_normal(
        tuple(bc.shape)), dtype=torch.float32, device=dev)
    a4 = (lvc.coeff, None, bc, x)
    got = fs.fused_sweep_3d(*a4, mode="resid")
    ref = fs.fused_sweep_3d_plain(*a4, mode="resid")
    torch.cuda.synchronize()
    ea4, er4 = rel_err(got, ref)
    check(er4 <= REL_TOL, f"{lab}: K4 resid pass on the {pmg.cshape[0]}^3 "
          f"corner level within {REL_TOL:g} (rel {er4:.2e})")
    res["K4"] = dict(max_abs_err=ea4)
    _s, single_c, _ch = single_and_chained(model._pmg, rho, _u)
    log(f"{lab}: {kc} PCG iterations (Jacobi corner smoother: {k}), "
        f"single-shot {single_c:.1f} ms")
    launches["brick20 corner chebyshev"] = cc
    del model, pmg, _u, _b

    # kernel="cuda": K8 element matrices
    lab = f"quadratic brick20 {n}^3 kernel=cuda"
    mc = quadratic_model(pt, dev, "brick20", n, kernel="cuda")
    _u, _b, kk, ck, _ms = quadratic_line(dev, pt, lab, mc, rho)
    check(ck["pyfem_stiffness_3d"] == 1 and abs(kk - k) <= 1,
          f"{lab}: K8 once per solve, iterations within 1 of einsum's ({k})")
    me = quadratic_model(pt, dev, "brick20", n, pmg=False)
    Kc, Ke = mc.element_jacobian(rho), me.element_jacobian(rho)
    ea8, er8 = rel_err(Kc, Ke)
    check(er8 <= REL_TOL, f"{lab}: K8 Ke within {REL_TOL:g} of the einsum "
          f"Ke (rel {er8:.2e})")
    fk, fp, _inp = stiffness_pair(mc, "brick20", "elasticity", rho)
    eap, erp = rel_err(fk(), fp())
    check(erp <= REL_TOL, f"{lab}: K8 within {REL_TOL:g} of its plain "
          f"version (rel {erp:.2e})")
    res["K8"] = dict(max_abs_err=max(ea8, eap))
    _s, single_k, _ch = single_and_chained(mc._pmg, rho, _u)
    log(f"{lab}: {kk} PCG iterations, single-shot {single_k:.1f} ms "
        f"(einsum: {single:.1f})")
    launches["brick20 kernel=cuda"] = ck
    del mc, me, Kc, Ke, _u, _b

    # the tet10 line: the 6-class lattice at 33^3
    nt = QUAD_TET_N
    lab = f"quadratic tet10 {nt}^3"
    mt = quadratic_model(pt, dev, "tet", nt)
    log(f"{lab}: {mt.nelems} elements, "
        f"{int((~mt._pmg.mask_all).sum())} live dof, corner levels "
        f"{mt._pmg.asm.sizes}")
    rt = torch.ones(mt.nnodes, dtype=torch.float32, device=dev)
    ut, bt, kt, ctt, _ms = quadratic_line(dev, pt, lab, mt, rt)
    check(mt._pmg._lat_off is not None and ctt["pyfem_assemble_3d"]
          == len(mt._pmg.asm.sizes) and ctt["pyfem_sweeps_3d"] > 0,
          f"{lab}: the 6-class lattice route, K3 once per corner level, "
          f"K5 launched")
    mv64, mvabs = pmg_f64_operator(pt, dev, "tet", nt, mt._pmg, rt)
    true_t, floor_t = residuals(mv64, mvabs, bt, ut)
    check(true_t <= FLOOR_FACTOR * floor_t,
          f"{lab}: true residual {true_t:.3e} <= {FLOOR_FACTOR:g} x float32 "
          f"floor {floor_t:.3e}")
    _s, single_t, ch_t = single_and_chained(mt._pmg, rt, ut)
    log(f"{lab}: {kt} PCG iterations, cheb_lam {mt._pmg._cheb_lam:.4f}, "
        f"single-shot {single_t:.1f} ms, chained {ch_t:.1f} ms/solve")
    launches["tet10"] = ctt
    del mt, mv64, mvabs
    out.update(launches=launches, kernels=res, k_cheb=kc,
               single_cheb=single_c, k_cuda=kk, single_cuda=single_k,
               k_tet=kt, single_tet=single_t)
    return out


TOPO3D_N = 33         # bench.py --topo-3d --n3d-topo 33: 65x33x33 nodes
TOPO3D_SCALE_N = 65   # the scale line: 129x65x65, 1,635,075 state dof
TOPO3D_WARMUP = 2
TOPO3D_ITERS = 40     # bench.py's --topo-iters
TOPO3D_SCALE_ITERS = 10
TOPO3D_EINSUM_N = 33  # the 3D einsum route's line: 33^3
TOPO3D_NAMES = ("pyfem_assemble_3d", "pyfem_sweep_3d", "pyfem_sweeps_3d")


def topo3d_setup(dev, pt, n):
    """``bench.py --config topo --topo-3d --n3d-topo n`` (bench.py:337-360,
    the reference's topo.py:150-152 block cantilever): (2n-1) x n x n hex8
    nodes, ``LinearElasticity(p=3, float32)``, ``attach_structured_grid(
    nu_pre=2, nu_post=2, min_n=3, bf16 smoother copy, omega="cheby")``
    (half-symmetric storage, the JAX 3D default), ``Helmholtz(r0=0.01,
    rtol=1e-6)`` on its structured grid; returns (model, filter, a
    ``DeviceTopo(fixed_volume=0.4, rtol=1e-6, maxiter=200)`` factory,
    lengths)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.opt import DeviceTopo

    nx, ny, nz = 2 * n - 1, n, n
    conn, X, fixed, force, L = problem(nx, ny, nz)
    model = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
    model.attach_structured_grid(nx, ny, nz, nu_pre=2, nu_post=2, min_n=3,
                                 smoother_dtype=torch.bfloat16,
                                 omega="cheby")
    filtr = pt.Helmholtz(0.01, "hex8", X, conn, dtype=torch.float32,
                         rtol=1e-6, device=dev)
    filtr.attach_structured_grid(nx, ny, nz)
    make = lambda: DeviceTopo(model, filtr, fixed_volume=0.4, rtol=1e-6,
                              maxiter=200)
    return model, filtr, make, L


def k4_filter_form(dev, filtr, x, label):
    """K4 at nd=1 on the filter's 27 full-storage planes (K and R) and
    the run's final design: against its plain version (<= REL_TOL of
    max|plain|), CUDA-event and device time, the bytes bound and the
    ``torch.sparse.mm`` time of the same product.  At 65x33x33 the
    operands (8.2 MB) stay in the L2 cache across back-to-back calls, so
    the kernel is timed with the L2 flushed before each call (``ms``,
    ``device_ms``; held against the device-memory bound) and, for the
    record, back to back (``l2_warm_ms``)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    shape = filtr._st_shape
    xr = x.reshape((1,) + shape).contiguous()
    worst = 0.0
    for name, c in (("K", filtr._coeffK), ("R", filtr._coeffR)):
        got = fs.fused_sweep_3d(c, x=xr, mode="matvec", neg_resid=True)
        ref = fs.fused_sweep_3d_plain(c, x=xr, mode="matvec", neg_resid=True)
        torch.cuda.synchronize()
        ea, er = rel_err(got, ref)
        worst = max(worst, ea)
        log(f"{label}: K4 nd=1 full-storage matvec on the filter's {name} "
            f"planes: max-abs {ea:.2e}, rel {er:.2e}")
        check(er <= REL_TOL, f"{label}: K4 nd=1 filter product ({name}) "
              f"within {REL_TOL:g} of plain")
    c = filtr._coeffK
    run = lambda: fs.fused_sweep_3d(c, x=xr, mode="matvec", neg_resid=True)
    nn = xr.numel()
    # per node: one FMA per plane (27); coefficients and x read once, y
    # written once
    b_ms, b_by = bound(nbytes(c, xr) + nbytes(xr), 2 * 27 * nn)
    flush = l2_flush(dev)
    r = dict(
        max_abs_err=worst, ms=cuda_ms(run, 50, between=flush),
        device_ms=device_ms(run, between=flush), l2_warm_ms=cuda_ms(run, 50),
        flush_device_ms=device_ms(flush),
        plain_ms=cuda_ms(lambda: fs.fused_sweep_3d_plain(
            c, x=xr, mode="matvec", neg_resid=True), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=library_matvec_ms(c.reshape((1, 1, 3, 3, 3) + shape),
                                     shape, xr))
    del flush
    log(f"{label}: K4 nd=1 filter matvec {'x'.join(map(str, shape[::-1]))}: "
        f"kernel {r['ms']:.4f} ms (device {fms(r['device_ms'])}; L2 flushed "
        f"before each call; the flush alone {fms(r['flush_device_ms'])}), "
        f"back to back {r['l2_warm_ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, torch.sparse.mm (f32 CSR) "
        f"{r['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return r


def topo3d_kernels(model, rho, label):
    """K3, K4 and K5 at every shape the loop gives them, on its final
    density and the state load, against their plain versions (<= REL_TOL
    of max|plain|): K3 on every level of the state hierarchy (half
    storage with the bf16 copy, as the loop assembles it); K4's nd=3
    matvec on every level's float32 half planes (the PCG operator runs
    on the fine one); K5's presmooth + residual (from x0 = 0) and
    postsmooth (from the presmooth's iterate) on the bf16 copy of every
    level the V-cycle smooths, with its Chebyshev-node factors, on the
    load restricted as the V-cycle restricts it.  The V-cycle's residual
    rides K5, so no bf16 K4 form runs on this path.  Returns each
    kernel's worst max-abs error."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar

    asm = model._gmg_asm
    rl = rho.reshape(model._gmg_shape).contiguous()
    worst = dict(K3=0.0, K4=0.0, K5=0.0)
    for st in asm.static_levels:
        args = (rl, st.maskf, st.W, asm.N)
        kw = dict(nd=3, p=asm.p, lp_dtype=torch.bfloat16, sym=True)
        got = fa.assemble_pack_3d(*args, **kw)
        ref = fa.assemble_pack_3d_plain(*args, **kw)
        torch.cuda.synchronize()
        (ea, er), (ia, ir) = rel_err(got[0], ref[0]), rel_err(
            got[1], ref[1], st.maskf > 0)
        worst["K3"] = max(worst["K3"], ea, ia)
        check(er <= REL_TOL and ir <= REL_TOL,
              f"{label}: K3 level {'x'.join(map(str, st.shape[::-1]))} "
              f"planes rel {er:.2e}, inv_diag rel {ir:.2e} within "
              f"{REL_TOL:g}")
        rl = multigrid._restrict_nodal(rl)
    gmg, _lv0 = asm.assemble(rho)
    b = interleave_to_planar(model.compute_rhs(), 3).reshape(
        (3,) + model._gmg_shape)
    for k, lv in enumerate(gmg.levels):
        if k:
            b = torch.where(lv.mask, 0.0, gmg.restrict_fn(b, lv.shape))
        b = torch.where(lv.mask, 0.0, b).contiguous()
        at = f"{label}: level {'x'.join(map(str, lv.shape[::-1]))}"
        mv = dict(mode="matvec", neg_resid=True)
        e4 = rel_err(fs.fused_sweep_3d(lv.coeff, x=b, **mv),
                     fs.fused_sweep_3d_plain(lv.coeff, x=b, **mv))
        worst["K4"] = max(worst["K4"], e4[0])
        check(e4[1] <= REL_TOL, f"{at} K4 nd=3 half-storage matvec (f32) "
              f"rel {e4[1]:.2e} within {REL_TOL:g}")
        if lv.dense_inv is not None:  # the coarsest: a dense solve
            continue
        pre = (lv.coeff_lp, lv.inv_diag, b, None)
        kw5 = dict(niter=gmg.nu_pre, want_resid=True,
                   omega=gmg._omegas(gmg.nu_pre))
        got = fs.fused_sweeps3d(*pre, **kw5)
        ref = fs.fused_sweeps3d_plain(*pre, **kw5)
        post = (lv.coeff_lp, lv.inv_diag, b, ref[0])
        kwp = dict(niter=gmg.nu_post, omega=gmg._omegas(gmg.nu_post,
                                                        reverse=True))
        got = tuple(got) + (fs.fused_sweeps3d(*post, **kwp),)
        ref = tuple(ref) + (fs.fused_sweeps3d_plain(*post, **kwp),)
        torch.cuda.synchronize()
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        worst["K5"] = max([worst["K5"]] + [e[0] for e in errs])
        check(all(e[1] <= REL_TOL for e in errs),
              f"{at} K5 presmooth x, its residual and postsmooth (bf16 "
              f"planes) rel " + ", ".join(f"{e[1]:.2e}" for e in errs)
              + f" within {REL_TOL:g}")
    return worst


def topo3d_line(dev, pt, i2p, n, iters, label, resume_check=False):
    """One line of phase 10 at --n3d-topo n: ``TOPO3D_WARMUP`` warm-up and
    ``iters`` timed MMA iterations through ``DeviceTopo.optimize``, with
    the measures phase 7 takes in 2D, K4's filter form, and (contract
    line) a 4-iteration run resumed at 2 against the uninterrupted one."""
    import torch
    from pathlib import Path
    from pyfem_gpu_testflight_tpu_torch import solvers
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    t0 = time.time()
    model, filtr, make, L = topo3d_setup(dev, pt, n)
    nx, ny, nz = 2 * n - 1, n, n
    dt = make()
    torch.cuda.synchronize()
    nlev = len(model._gmg_asm.sizes)
    log(f"{label}: {nx}x{ny}x{nz} nodes, {model.ndof} state dof, "
        f"{model.nnodes} design variables, levels {model._gmg_asm.sizes}, "
        f"set-up {time.time() - t0:.2f} s")
    t0 = time.time()
    dt.optimize(max_iterations=TOPO3D_WARMUP, verbose=False,
                log_every=TOPO3D_WARMUP)
    torch.cuda.synchronize()
    log(f"{label}: {TOPO3D_WARMUP}-iteration warm-up {time.time() - t0:.2f} s")

    # the timed run: launches and read-backs snapshotted at every stage
    snaps = []

    def snapshot(stage):
        snaps.append((stage, dict(
            {k: _cuda.launches[k] for k in TOPO3D_NAMES},
            **solvers.readbacks)))

    dt.history.clear()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    snapshot("start")
    dt.mark = snapshot
    log_every = max(1, iters // 4)
    x, rho = dt.optimize(max_iterations=iters, verbose=False,
                         log_every=log_every)
    torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() - base
    dt.mark = None
    per_it, cur = [], {}
    for (_s, a), (stage, b) in zip(snaps, snaps[1:]):
        cur[stage] = {k: b[k] - a[k] for k in b}
        if stage == "mma_update":
            per_it.append(cur)
            cur = {}
    tot = lambda it, k: sum(d[k] for d in it.values())
    k3 = [tot(it, "pyfem_assemble_3d") for it in per_it]
    k4s = [it["state_pcg"]["pyfem_sweep_3d"] for it in per_it]
    k4f = [it["filter_fwd"]["pyfem_sweep_3d"]
           + it["filter_bwd"]["pyfem_sweep_3d"] for it in per_it]
    k5 = [tot(it, "pyfem_sweeps_3d") for it in per_it]
    reads = [tot(it, "pcg") + tot(it, "cg") for it in per_it]
    hist = dt.history
    cg = [h["cg_iters"] for h in hist]
    fi = [h["filter_iters"] for h in hist]
    objs = [h["obj"] for h in hist]
    # filter products per iteration: R once forward and once backward, and
    # one per PCG iteration of each solve, which runs whole blocks of
    # CHECK_EVERY (iterations past convergence masked)
    blocks = lambda k: max(1, -(-k // solvers.CHECK_EVERY))
    k4f_want = [2 + solvers.CHECK_EVERY * (blocks(f) + blocks(b))
                for f, b in fi]
    vol = float(model.volume(rho))
    log(f"{label}: {iters} timed MMA iterations in {dt.elapsed:.3f} s, "
        f"{dt.s_per_iter:.4f} s/iteration (CUDA-synchronized; steady "
        f"{dt.steady_s_per_iter:.4f}); compliance {objs[0]:.6e} -> "
        f"{objs[-1]:.6e}, volume {vol:.5f}")
    log(f"{label}: state PCG iterations {cg}")
    log(f"{label}: filter PCG iterations (fwd, bwd) {fi}")
    log(f"{label}: launches per iteration K3 {k3}, K4 state operator "
        f"{k4s}, K4 filter {k4f}, K5 {k5}")
    log(f"{label}: host read-backs per iteration {reads} (state PCG r.r "
        f"per PCG iteration, filter flag per 16; plus {iters // log_every} "
        f"stats drains in all); peak device memory {mem / 2**20:.1f} MiB "
        f"above the {base / 2**20:.1f} MiB allocated before the run")
    check(len(hist) == iters and all(np.isfinite(objs))
          and all(0 < c <= 200 for c in cg),
          f"{label}: {iters} iterations, finite history, every state solve "
          f"converged (the drain checks each)")
    check(len(per_it) == iters and all(k == nlev for k in k3)
          and all(a == c + 1 for a, c in zip(k4s, cg))
          and all(k == 2 * (nlev - 1) * (c + 1) for k, c in zip(k5, cg))
          and k4f == k4f_want,
          f"{label}: K3 once per level, K4 once per PCG iteration (+1, the "
          f"warm start's residual) and in every filter product ({k4f_want}"
          f": the R products and {solvers.CHECK_EVERY} per block of filter "
          f"PCG iterations), K5 twice per V-cycle level")

    stages, step_ms, busy = topo_stages(dt, label, iters)

    # the first iteration's float32 compliance against a float64-outer
    # solve of the same state system
    x0 = torch.full((model.nnodes,), 0.95, dtype=torch.float32, device=dev)
    rho0 = torch.clamp(filtr.apply(x0), min=dt.rho_floor)
    gmg, lv0 = model._gmg_asm.assemble(rho0)
    b = torch.where(lv0.mask, 0.0,
                    i2p(model.compute_rhs(), 3).reshape(3, nz, ny, nx))
    mv64, mvabs, c64p = f64_operator_3d((nx, ny, nz), L, rho0, 3.0, dev)
    xa, ka, _ = accuracy_solve(gmg, mv64, b)
    true_a, _ = residuals(mv64, mvabs, b, xa)
    c64 = float(torch.dot(b.double().reshape(-1), xa.reshape(-1)))
    rel64 = abs(objs[0] - c64) / abs(c64)
    log(f"{label}: first iteration compliance float32 {objs[0]:.8e}, "
        f"float64-outer ({ka} iterations, true residual {true_a:.2e}) "
        f"{c64:.8e}: rel diff {rel64:.3e}")
    check(true_a <= 1e-5, f"{label}: float64-outer true residual <= 1e-5")
    del mv64, mvabs, c64p, gmg, lv0, xa

    out = dict(n=n, dims=(nx, ny, nz), ndof=model.ndof,
               nnodes=model.nnodes, s_per_iter=dt.s_per_iter,
               steady=dt.steady_s_per_iter, cg=cg, fi=fi, objs=objs,
               vol=vol, mem=mem, busy=busy, stages=stages,
               step_ms=step_ms, rel64=rel64,
               launches=dict(K3=sum(k3), K4_state=sum(k4s),
                             K4_filter=sum(k4f), K5=sum(k5)),
               reads=reads)
    out["k4_filter"] = k4_filter_form(dev, filtr, x, label)
    out["kernels"] = topo3d_kernels(model, torch.clamp(rho, min=dt.rho_floor),
                                    label)
    if resume_check:
        ck = Path("build") / "chip_smoke" / "topo3d_checkpoint.npz"
        ck.parent.mkdir(parents=True, exist_ok=True)
        d_full = make()
        x4, _ = d_full.optimize(max_iterations=4, verbose=False, log_every=2)
        make().optimize(max_iterations=2, verbose=False, log_every=2,
                        checkpoint_path=str(ck))
        d_res = make()
        x4r, _ = d_res.optimize(max_iterations=4, verbose=False, log_every=2,
                                resume=str(ck))
        same = torch.equal(x4, x4r) and [h["obj"] for h in d_res.history] \
            == [h["obj"] for h in d_full.history]
        log(f"{label}: 4 iterations resumed at 2 vs uninterrupted: "
            f"bit-identical {same} (objectives "
            f"{[h['obj'] for h in d_res.history]})")
        check(same, f"{label}: a run resumed at iteration 2 equals the "
              f"uninterrupted run bit for bit")
    return out


def einsum_route_3d(dev, pt, multigrid, i2p):
    """The 3D einsum route (``elem_path="einsum"``: einsum element
    matrices, ``Stencil3D.assemble``, elimination; K5 smooths, K4 is the
    PCG operator) at 33^3 in both storages, against the uniform (K3)
    route on the same bench-3D-like system (p=3, a seeded density)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    n = TOPO3D_EINSUM_N
    conn, X, fixed, force, L = problem(n, n, n)
    model = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=3.0,
                                dtype=torch.float32, device=dev)
    rho = torch.as_tensor(np.random.default_rng(SEED + 10).uniform(
        0.3, 1.0, model.nnodes), dtype=torch.float32, device=dev)
    b = None
    out = {}
    for sym in (True, False):
        for path in ("uniform", "einsum"):
            asm = multigrid.GMGAssembler3D(
                n, n, n, *L, "elasticity", p=3.0, dtype=torch.float32,
                device=dev, nu_pre=2, nu_post=2, min_n=3,
                smoother_dtype=torch.bfloat16, omega="cheby",
                elem_path=path, sym=sym)
            _cuda.reset_launches()
            gmg, lv0 = asm.assemble(rho)
            if b is None:
                b = torch.where(lv0.mask, 0.0, i2p(model.compute_rhs(), 3)
                                .reshape(3, n, n, n))
            _x, k, rn = multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6,
                                          maxiter=200, flexible=True)
            torch.cuda.synchronize()
            c = {k_: _cuda.launches[k_] for k_ in TOPO3D_NAMES}
            out[(sym, path)] = dict(k=k, launches=c)
            ok = float(rn) <= 1e-6 * float(torch.linalg.norm(b))
            log(f"einsum route {n}^3 sym={sym} {path}: {k} PCG iterations, "
                f"converged {ok}, launches {c}")
            check(ok, f"3D {path} route {n}^3 sym={sym} converges")
        e, u = out[(sym, "einsum")], out[(sym, "uniform")]
        check(e["launches"]["pyfem_assemble_3d"] == 0
              and e["launches"]["pyfem_sweep_3d"] > 0
              and e["launches"]["pyfem_sweeps_3d"] > 0,
              f"3D einsum route sym={sym}: K4 and K5 launched, K3 not")
        log(f"einsum route {n}^3 sym={sym}: {e['k']} PCG iterations against "
            f"the uniform route's {u['k']}")
    return {f"{'sym' if s else 'full'} {p}": v for (s, p), v in out.items()}


def phase_topo3d(dev, pt, multigrid, i2p):
    """Phase 10: 3D topology optimization, ``bench.py --config topo
    --topo-3d`` (bench.py:337-360) on the card: the contract line at
    --n3d-topo 33 (65x33x33, 2 warm-up + 40 timed MMA iterations, the
    bench's counts; final volume <= 0.4 + 5e-3, tests/test_topo_device.py's
    gate; a resumed run bit-identical), the scale line at n = 65
    (129x65x65, 1,635,075 state dof, 2 + 10 iterations), K4's nd=1
    filter form on each line's planes, and the 3D einsum route at 33^3
    in both storages."""
    con = topo3d_line(dev, pt, i2p, TOPO3D_N, TOPO3D_ITERS, "topo3d",
                      resume_check=True)
    check(con["vol"] <= 0.4 + 5e-3, f"topo3d: final volume {con['vol']:.5f} "
          f"<= 0.405 after {TOPO3D_ITERS} iterations")
    scale = topo3d_line(dev, pt, i2p, TOPO3D_SCALE_N, TOPO3D_SCALE_ITERS,
                        "topo3d scale")
    ein = einsum_route_3d(dev, pt, multigrid, i2p)
    return dict(contract=con, scale=scale, einsum=ein)


def run_topo3d():
    """``python3 chip_smoke.py --topo3d``: only phase 10 (with the kernel
    build); prints the card and one JSON line of its figures."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p,
    )

    log(card_line())
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    out = phase_topo3d(torch.device("cuda", 0), pt, multigrid, i2p)
    log(json.dumps(topo3d_summary(out)))
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    return 0


def topo3d_summary(out):
    """Phase 10's figures as one JSON-able dict."""
    keep = ("dims", "ndof", "nnodes", "s_per_iter", "steady", "vol", "mem",
            "busy", "stages", "step_ms", "rel64", "launches", "k4_filter")
    lines = {}
    for name in ("contract", "scale"):
        o = out[name]
        lines[name] = {k: o[k] for k in keep}
        lines[name].update(
            cg_first_last=(o["cg"][0], o["cg"][-1]),
            filter_first_last=(o["fi"][0], o["fi"][-1]),
            compliance_first_last=(o["objs"][0], o["objs"][-1]),
            reads_per_iter=float(np.mean(o["reads"])))
    return {"topo3d": lines, "einsum_route_33": out["einsum"]}


UNS_ARM = (257, 2049)       # torque arm: 526,593 nodes, 1,053,186 dof
UNS_ARM_YARD = (129, 1025)  # the SuperLU yardstick's arm, 264,450 dof
UNS_BRACKET_N = 33          # C3D10 bracket 65x33x33: 212,355 dof
UNS_BRACKET_YARD_N = 17     # the float64 bracket against SuperLU
UNS_BRACKET_OFFSETS = 32768  # its RCM band has ~27,700 diagonals
UNS_TOPO_WARMUP, UNS_TOPO_ITERS = 2, 5  # arm loop: 2 warm-up + 5 timed
UNS_BRACKET_TOPO_ITERS = 4
UNS_YARD_TOL = 1e-8         # rel L2 against SuperLU (test_unstructured:43)
UNS_ARM_RES_TOL = 2e-10     # the float64 arm's true residual
U_NAMES = ("pyfem_csr_spmv", "pyfem_dia_spmv", "pyfem_stiffness_3d")


def uns_dir():
    from pathlib import Path

    d = Path("build") / "chip_smoke"
    d.mkdir(parents=True, exist_ok=True)
    return d


def true_residual(K, b, u):
    """Host float64 ||b - K u|| / ||b|| (u from the card)."""
    u = u.detach().double().cpu().numpy()
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(b - K.astype(np.float64) @ u)
                 / np.linalg.norm(b))


def f32_check(K32, b, u, rtol, label):
    """A float32 solve of the float32 system K32 u = b: its float64 true
    residual on K32 itself, held to FLOOR_FACTOR x max(rtol, its float32
    rounding floor u32 ||K32| |u|| / ||b||).  Returns (residual,
    floor)."""
    from scipy import sparse

    u64 = u.detach().double().cpu().numpy()
    b = np.asarray(b, dtype=np.float64)
    K64 = sparse.csr_matrix(K32, dtype=np.float64)
    res = float(np.linalg.norm(b - K64 @ u64) / np.linalg.norm(b))
    floor = 2.0 ** -24 * float(np.linalg.norm(abs(K64) @ np.abs(u64))
                                / np.linalg.norm(b))
    lim = FLOOR_FACTOR * max(rtol, floor)
    log(f"{label}: float64 true residual on its float32 operator "
        f"{res:.3e}, float32 rounding floor {floor:.3e}")
    check(res <= lim, f"{label}: true residual {res:.3e} <= {FLOOR_FACTOR:g}"
          f" x max(rtol, floor) = {lim:.3e}")
    return res, floor


def share_pattern(dst, src):
    """Hand a model the host sparsity pattern of another model of the same
    mesh (it depends on the dof connectivity only)."""
    if np.array_equal(dst.conn_dof_host, src.conn_dof_host):
        dst._pattern = src.pattern


def flushed_times(run, flush, reps=50):
    """A kernel's times with the L2 flushed before each call (``ms``,
    ``device_ms``: what its bytes bound assumes) and back to back
    (``l2_warm_ms``, ``l2_warm_device_ms``)."""
    return dict(ms=cuda_ms(run, reps, between=flush),
                device_ms=device_ms(run, between=flush),
                l2_warm_ms=cuda_ms(run, reps),
                l2_warm_device_ms=device_ms(run))


def csr_library_ms(op, x):
    """One ``torch.sparse`` CSR product of the same matrix (the
    yardstick; the port never calls it), built outside the timed span."""
    import torch

    A = torch.sparse_csr_tensor(op.indptr.long(), op.indices.long(),
                                op.vals.to(x.dtype), (op.n, op.n))
    xv = x.reshape(-1, 1)
    ms = cuda_ms(lambda: torch.sparse.mm(A, xv), 20)
    del A
    return ms


def u1_check_levels(amg, label, rng):
    """U1 against its plain version on every level of ``amg``'s
    hierarchy, in float32 and float64 (the level's values cast), at
    ``REL_TOL`` of max|plain|.  Returns the worst max-abs error."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import spmv

    worst = 0.0
    for k, lv in enumerate(amg.levels):
        op = lv["op"]
        for dt in (torch.float32, torch.float64):
            v = op.vals.to(dt)
            x = torch.as_tensor(rng.standard_normal(op.n), dtype=dt,
                                device=v.device)
            got = spmv.csr_matvec(op.indptr, op.indices, v, x)
            ref = spmv.csr_matvec_plain(op.indptr, op.indices, v, x)
            torch.cuda.synchronize()
            ea, er = rel_err(got, ref)
            worst = max(worst, ea)
            check(er <= REL_TOL and got.dtype == dt,
                  f"{label}: U1 level {k} (n {op.n}, nnz {op.nnz}) "
                  f"{str(dt)[6:]} within {REL_TOL:g} of plain (rel "
                  f"{er:.2e})")
    return worst


def u1_groups(op, v, x):
    """U1's CUDA-event time at every lanes-per-row group on one matrix
    (the entry point called directly; the wrapper picks one), for the
    record."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    y = torch.empty_like(x)
    out = {}
    for g in (1, 2, 4, 8, 16, 32):
        out[g] = cuda_ms(lambda: _cuda.launch(
            "pyfem_csr_spmv", op.indptr.data_ptr(), op.indices.data_ptr(),
            v.data_ptr(), x.data_ptr(), y.data_ptr(), op.n, g,
            int(x.dtype == torch.float64), _cuda.stream_ptr(x)), 20)
    return out


def u1_timed(op, dt, rng, label):
    """U1's times on one level matrix in ``dt``: CUDA events and device
    time (the L2 flushed before each call where the operands fit in 50
    MB, else back to back), its plain version, the bytes bound (indptr,
    columns and values read once, x read once, y written once) and the
    ``torch.sparse`` CSR product."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import spmv

    v = op.vals.to(dt)
    x = torch.as_tensor(rng.standard_normal(op.n), dtype=dt,
                        device=v.device)
    run = lambda: spmv.csr_matvec(op.indptr, op.indices, v, x)
    y = run()
    b_ms, b_by = bound(nbytes(op.indptr, op.indices, v, x, y),
                       2 * op.nnz, F32_FLOP_S if dt == torch.float32
                       else F64_FLOP_S)
    fits = nbytes(op.indptr, op.indices, v, x, y) <= 50e6
    flush = l2_flush(v.device)
    t = flushed_times(run, flush) if fits else dict(
        ms=cuda_ms(run, 50), device_ms=device_ms(run))
    del flush
    r = dict(t, plain_ms=cuda_ms(lambda: spmv.csr_matvec_plain(
        op.indptr, op.indices, v, x), 5), bound_ms=b_ms, bound_by=b_by,
        library_ms=csr_library_ms(op, x), n=op.n, nnz=op.nnz,
        l2_flushed=fits, group=spmv.csr_group(op.n, op.nnz),
        groups_ms=u1_groups(op, v, x))
    log(f"{label}: U1 {str(dt)[6:]} n {op.n} nnz {op.nnz}: kernel "
        f"{r['ms']:.4f} ms (device {fms(r['device_ms'])}"
        f"{'; L2 flushed' if fits else ''}), plain {r['plain_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), torch.sparse CSR "
        f"{r['library_ms']:.4f} ms; lanes per row {r['group']}, by group "
        + ", ".join(f"{g}: {ms:.4f}" for g, ms in r["groups_ms"].items()))
    return r


def u2_timed(dia_op, vals, u, label, mask=None, csr_op=None):
    """U2 on a DIA matrix: against its plain version (REL_TOL), times
    (the L2 flushed where the operands fit in 50 MB), the bound (every
    stored diagonal read once, u read once, y written once) and the
    ``torch.sparse`` CSR product of the same matrix."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import spmv

    offs = dia_op.offsets_on(u.device)
    got = spmv.dia_matvec(offs, vals, u, mask)
    ref = spmv.dia_matvec_plain(offs, vals, u, mask)
    torch.cuda.synchronize()
    ea, er = rel_err(got, ref)
    check(er <= REL_TOL, f"{label}: U2 ({dia_op.noffs} diagonals, "
          f"{'masked' if mask is not None else 'plain'}) within "
          f"{REL_TOL:g} of plain (rel {er:.2e})")
    run = lambda: spmv.dia_matvec(offs, vals, u, mask)
    moved = nbytes(offs, vals, u, got, mask)
    b_ms, b_by = bound(moved, 2 * vals.numel(),
                       F32_FLOP_S if u.dtype == torch.float32
                       else F64_FLOP_S)
    fits = moved <= 50e6
    flush = l2_flush(u.device)
    t = flushed_times(run, flush) if fits else dict(
        ms=cuda_ms(run, 10), device_ms=device_ms(run, reps=5))
    del flush
    lib = None
    if csr_op is not None:
        lib = csr_library_ms(csr_op, u)
    r = dict(t, max_abs_err=ea, plain_ms=cuda_ms(lambda: spmv.dia_matvec_plain(
        offs, vals, u, mask), 3), bound_ms=b_ms, bound_by=b_by,
        library_ms=lib, noffs=dia_op.noffs, n=u.numel(), l2_flushed=fits)
    log(f"{label}: U2 {dia_op.noffs} diagonals x {u.numel()} rows: kernel "
        f"{r['ms']:.4f} ms (device {fms(r['device_ms'])}), plain "
        f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"torch.sparse CSR {fms(lib)} ms")
    return r


def amg_breakdown(model, label, rng):
    """The last ``solve(method="amg")`` of ``model`` in parts on the card,
    from the hierarchy, operator and runner it left in ``_amg_cache``:
    the PCG alone (CUDA-synchronized host clock, the system's load), ms
    per V-cycle (CUDA events), U1 launches and device activities per
    V-cycle, the levels (n, nnz, diagonals) and the busy share of one
    PCG run (device rows over its unprofiled time).  Returns (figures,
    the hierarchy)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    cache = model._amg_cache
    amg, A0, run = cache["amg"], cache["A0"], cache["run"]
    b = model.compute_rhs().to(model.dtype)
    bp = torch.where(model.bc.mask, 0.0, b)[amg.perm]
    rtol = model._uns_rtol
    torch.cuda.synchronize()
    t0 = time.time()
    x, k, rn = run(A0, amg, bp, rtol, 0.0)
    torch.cuda.synchronize()
    t_pcg = time.time() - t0
    r = torch.as_tensor(rng.standard_normal(amg.levels[0]["n"]),
                        dtype=amg.dtype, device=model.device)
    _cuda.reset_launches()
    amg.apply(r)
    torch.cuda.synchronize()
    u1_per_cycle = _cuda.launches["pyfem_csr_spmv"]
    vc_ms = cuda_ms(lambda: amg.apply(r), 10)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        amg.apply(r)
        torch.cuda.synchronize()
    acts = sum(rw.count for rw in device_rows(prof))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(A0, amg, bp, rtol, 0.0)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    busy_ms = sum(dev_us(rw) for rw in rows) / 1e3
    busy = 100 * busy_ms / (1e3 * t_pcg) if rows else None
    levels = [(lv["n"], lv["op"].nnz) for lv in amg.levels]
    out = dict(pcg_s=t_pcg, iters=int(k), vcycle_ms=vc_ms,
               ms_per_iter=1e3 * t_pcg / max(int(k), 1),
               u1_per_vcycle=u1_per_cycle, device_acts_per_vcycle=acts,
               levels=levels, busy=busy,
               pcg_device_ms=busy_ms if rows else None,
               diagonals=[int(sl["offsets"].size)
                          for sl in amg.structure["levels"]])
    log(f"{label}: PCG alone {t_pcg:.3f} s ({int(k)} iterations, "
        f"{out['ms_per_iter']:.2f} ms each); V-cycle {vc_ms:.3f} ms, "
        f"{u1_per_cycle} U1 launches and {acts} device activities per "
        f"V-cycle; levels (n, nnz) {levels}, diagonals per level "
        f"{out['diagonals']}; PCG device time "
        f"{fms(out['pcg_device_ms'])} ms, busy "
        + ("not measured" if busy is None else f"{busy:.1f}%"))
    if rows:
        for rw in sorted(rows, key=dev_us, reverse=True)[:6]:
            log(f"  {dev_us(rw) / 1e3:9.3f} ms {rw.count:6d}x  "
                f"{rw.key[:90]}")
    return out, amg


def uns_solve(model, label, rtol, names=U_NAMES):
    """One ``model.solve(method="amg")`` through the entry point, the
    launch counts zeroed just before and read just after, with its peak
    memory and host-clock parts."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    model._uns_rtol = rtol
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.time()
    u = model.solve(method="amg", rtol=rtol)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {k: _cuda.launches[k] for k in names}
    mem = torch.cuda.max_memory_allocated() - base
    st = dict(model.last_solve_stats)
    log(f"{label}: solve(method='amg', rtol={rtol:g}) {wall:.3f} s (scipy "
        f"assembly + BCs {st['assemble_s']:.3f} s, AMG set-up "
        f"{st['setup_s']:.3f} s, PCG {st['pcg_s']:.3f} s), {st['iters']} "
        f"iterations, {st['readbacks']} read-backs, launches {counts}, "
        f"peak device memory {mem / 2**20:.1f} MiB above "
        f"{base / 2**20:.1f} MiB")
    return u, dict(st, wall_s=wall, counts=counts, mem=mem)


def uns_yardstick(model, label, rtol=1e-10):
    """float64 AMG-PCG against host SuperLU: rel L2 <= UNS_YARD_TOL."""
    import torch

    u = model.solve(method="amg", rtol=rtol)
    k = model.last_solve_stats["iters"]
    t0 = time.time()
    ud = model.solve(method="direct")
    t_lu = time.time() - t0
    rel = float(torch.linalg.norm(u.cpu() - ud.cpu())
                / torch.linalg.norm(ud.cpu()))
    log(f"{label}: {model.ndof} dof, AMG-PCG {k} iterations vs SuperLU "
        f"({t_lu:.2f} s): rel L2 {rel:.3e}")
    check(rel <= UNS_YARD_TOL, f"{label}: AMG within {UNS_YARD_TOL:g} of "
          f"SuperLU (rel L2 {rel:.3e})")
    return dict(ndof=model.ndof, iters=k, rel=rel, superlu_s=t_lu)


def uns_topo(prob, model, filtr, label, warmup, iters):
    """An MMA loop on the host loop (``opt.TopoProblem`` with AMG state
    solves) timed per iteration (CUDA-synchronized), its stages by
    wrappers on the model's and filter's methods: filter forward, state
    (element matrices, scipy assembly, AMG set-up, PCG), sensitivity,
    filter backward, and the MMA update as the rest."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import unstructured as pu
    from pyfem_gpu_testflight_tpu_torch.opt import MMA

    stage = {}
    state = []

    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage.setdefault(key, []).append(time.time() - t0)
            if key == "state":
                st = model.last_solve_stats
                state.append((st["iters"], st["assemble_s"], st["setup_s"],
                              st["pcg_s"]))
            return out

        setattr(obj, name, timed)

    wrap(filtr, "apply", "filter_fwd")
    wrap(filtr, "apply_gradient", "filter_bwd")
    wrap(model, "compliance", "state")
    wrap(model, "compliance_grad", "sensitivity")
    ticks = []

    def callback(k, x, obj, con):
        torch.cuda.synchronize()
        ticks.append(time.time())

    n0 = pu.AMGPreconditioner.n_structure_setups
    torch.cuda.synchronize()
    t0 = time.time()
    opt = MMA(prob, {"max_iterations": warmup + iters, "verbose": False,
                     "callback": callback})
    x = opt.optimize()
    torch.cuda.synchronize()
    total = time.time() - t0
    setups = pu.AMGPreconditioner.n_structure_setups - n0
    steps = np.diff([t0] + ticks)
    timed = steps[warmup:]
    objs = [h["obj"] for h in opt.history]
    cons = [h["con"][0] for h in opt.history]
    n_it = len(opt.history)
    per_it = {k: float(np.sum(v)) / max(n_it, 1) for k, v in stage.items()}
    per_it["mma_update"] = float(np.mean(steps)) - sum(per_it.values())
    log(f"{label}: {n_it} MMA iterations in {total:.2f} s, "
        f"{float(np.mean(timed)) if len(timed) else float('nan'):.3f} s per "
        f"timed iteration ({warmup} warm-up); stages per iteration (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in per_it.items()))
    log(f"{label}: state solves (PCG iterations, assembly s, AMG set-up s, "
        f"PCG s): {[tuple(round(v, 3) for v in s_) for s_ in state]}")
    log(f"{label}: compliance {objs[0]:.6e} -> {objs[-1]:.6e}, constraint "
        f"{cons[0]:+.4e} -> {cons[-1]:+.4e}; structural AMG set-ups {setups}")
    rho = filtr.apply(torch.as_tensor(x, device=model.device)).cpu().numpy()
    check(setups == 1, f"{label}: one structural AMG set-up for the loop "
          f"({setups})")
    check(n_it == warmup + iters and all(np.isfinite(objs))
          and len(state) >= n_it,
          f"{label}: {warmup + iters} iterations, a finite history, every "
          f"state solve converged")
    check(cons[0] < 0 and cons[-1] > cons[0],
          f"{label}: the volume constraint approached from the solid start")
    check(rho.min() > -0.05 and rho.max() < 1.05,
          f"{label}: filtered density within [-0.05, 1.05]")
    return dict(s_per_iter=float(np.mean(timed)) if len(timed) else None,
                steps=[float(s) for s in steps], stages=per_it,
                state=state, objs=objs, cons=cons, setups=setups,
                total_s=total)


def uns_arm_line(dev, pt, rng):
    """The arm line of phase 11 (see :func:`phase_unstructured`)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import unstructured as pu
    from pyfem_gpu_testflight_tpu_torch.examples import (
        torque_arm, torque_arm_topo,
    )

    nr, nt = UNS_ARM
    t0 = time.time()
    inp = str(uns_dir() / f"arm_{nr}x{nt}.inp")
    torque_arm.synthesize_arm_inp(inp, nr=nr, nt=nt)
    t_syn = time.time() - t0
    t0 = time.time()
    model, X, conn, groups = torque_arm.arm_model(inp, device=dev)
    t_parse = time.time() - t0
    log(f"arm: {nr}x{nt} polar nodes, {model.nnodes} nodes, "
        f"{model.nelems} CPS3 elements, {model.ndof} dof; .inp written in "
        f"{t_syn:.2f} s, parsed + model in {t_parse:.2f} s")
    check(model.ndof == 1053186 and model.nelems == 1048576,
          "arm: 1,053,186 dof, 1,048,576 tri3 elements")

    # the host sparsity pattern (38M element-matrix keys), built apart
    # so that the solve's assembly time below is the per-solve part
    from pyfem_gpu_testflight_tpu_torch import native

    t0 = time.time()
    native.get_lib()
    t_lib = time.time() - t0
    t0 = time.time()
    model.pattern
    t_pat = time.time() - t0
    t0 = time.time()
    model.pattern.segments(dev)
    torch.cuda.synchronize()
    t_seg = time.time() - t0
    log(f"arm: native library {t_lib:.2f} s (built here: "
        f"{native.get_lib() is not None}), host sparsity pattern "
        f"{t_pat:.2f} s ({model.pattern.nnz} nonzeros), its device "
        f"segments {t_seg:.2f} s")
    # the main path: the entry point's AMG-PCG solve, fresh set-up
    n0 = pu.AMGPreconditioner.n_structure_setups
    u, st = uns_solve(model, "arm float64", 1e-10)
    check(pu.AMGPreconditioner.n_structure_setups == n0 + 1,
          "arm: one fresh structural set-up")
    check(st["counts"]["pyfem_csr_spmv"] > 0,
          "arm: U1 launched on the main path")
    brk, amg = amg_breakdown(model, "arm float64", rng)
    K, b = model.bc.apply_scipy(
        model.assemble_scipy(model.element_jacobian(1.0)),
        model.compute_rhs().cpu().numpy())
    res = true_residual(K, b, u)
    log(f"arm float64: true residual ||b - K u||/||b|| {res:.3e}")
    check(res <= UNS_ARM_RES_TOL, f"arm float64: true residual {res:.3e} "
          f"<= {UNS_ARM_RES_TOL:g}")
    check(st["readbacks"] <= st["iters"] // 16 + 1,
          "arm: read-backs <= iterations/16 + 1")
    run1 = model._amg_cache["run"]
    A0_host = amg.A0

    # a second solve at another density: no structural set-up, same runner
    rho2 = torch.as_tensor(rng.uniform(0.3, 1.0, model.nnodes), device=dev)
    n1 = pu.AMGPreconditioner.n_structure_setups
    t0 = time.time()
    u2 = model.solve(method="amg", rho=rho2, rtol=1e-10)
    torch.cuda.synchronize()
    st2 = dict(model.last_solve_stats, wall_s=time.time() - t0)
    check(pu.AMGPreconditioner.n_structure_setups == n1
          and model._amg_cache["run"] is run1,
          "arm: a second solve at another density does no structural "
          "set-up and reuses the runner")
    K2, b2 = model.bc.apply_scipy(
        model.assemble_scipy(model.element_jacobian(rho2)),
        model.compute_rhs().cpu().numpy())
    res2 = true_residual(K2, b2, u2)
    del K2, b2
    log(f"arm second solve (rho ~ U[0.3, 1]): {st2['wall_s']:.3f} s "
        f"(assembly + BCs {st2['assemble_s']:.3f}, value-only set-up "
        f"{st2['setup_s']:.3f}, PCG {st2['pcg_s']:.3f}), {st2['iters']} "
        f"iterations, true residual {res2:.3e}")

    # a float32 V-cycle under the float64 CG, the same system
    model.amg_options = {"precond_dtype": torch.float32}
    uf = model.solve(method="amg", rtol=1e-10)
    stf = dict(model.last_solve_stats)
    resf = true_residual(K, b, uf)
    model.amg_options = {}
    log(f"arm float64 CG, float32 V-cycle: {stf['iters']} iterations, "
        f"PCG {stf['pcg_s']:.3f} s, true residual {resf:.3e}")

    # rigid-body modes against translations only, the same system
    xt, kt, _ = pu.amg_pcg(K, b, nd=2, rtol=1e-10, device=dev)
    log(f"arm: rigid-body modes {st['iters']} iterations, translations "
        f"only {int(kt)}")
    check(st["iters"] < int(kt), "arm: rigid-body modes beat translations")
    del xt

    k1 = dict(max_abs_err=u1_check_levels(amg, "arm", rng))
    fine = amg.levels[0]["op"]
    k1["f32"] = u1_timed(fine, torch.float32, rng, "arm fine level")
    k1["f64"] = u1_timed(fine, torch.float64, rng, "arm fine level")
    # U2 on the same fine matrix as DIA (float32), against U1
    dia_op, dia_vals, _offs = pu.csr_to_dia(A0_host, torch.float32,
                                            max_offsets=4096, device=dev)
    ua = torch.as_tensor(rng.standard_normal(model.ndof),
                         dtype=torch.float32, device=dev)
    k2 = u2_timed(dia_op, dia_vals, ua, "arm fine level (DIA)",
                  csr_op=fine)
    from pyfem_gpu_testflight_tpu_torch.ops import spmv

    yd = spmv.dia_matvec(dia_op.offsets_on(dev), dia_vals, ua)
    yc = spmv.csr_matvec(fine.indptr, fine.indices, fine.vals.float(), ua)
    torch.cuda.synchronize()
    e_dc = rel_err(yd, yc)[1]
    check(e_dc <= REL_TOL, f"arm: U2 (DIA) and U1 (CSR) agree on the fine "
          f"matrix (rel {e_dc:.2e})")
    csr_gb = nbytes(fine.indptr, fine.indices, fine.vals.float()) / 1e9
    log(f"arm fine matrix: {dia_op.noffs} diagonals, DIA "
        f"{nbytes(dia_vals) / 1e9:.3f} GB against CSR {csr_gb:.3f} GB "
        f"(float32 values); fill {100 * fine.nnz / dia_vals.numel():.2f}%")
    del dia_vals, yd, yc, amg, A0_host, fine

    # float32 model at rtol 1e-6
    m32 = torque_arm.arm_model(inp, device=dev, dtype=torch.float32)[0]
    share_pattern(m32, model)
    u32, st32 = uns_solve(m32, "arm float32", 1e-6)
    res32 = true_residual(K, b, u32)
    K32, b32 = m32.bc.apply_scipy(
        m32.assemble_scipy(m32.element_jacobian(1.0)),
        m32.compute_rhs().cpu().numpy())
    own32, floor32 = f32_check(K32, b32, u32, 1e-6, "arm float32")
    log(f"arm float32: {st32['iters']} iterations, float64 true residual "
        f"on the float64 operator {res32:.3e}")
    del m32, u32, K32, b32

    # yardstick: the 129x1025 arm against host SuperLU
    ny_, nt_ = UNS_ARM_YARD
    yinp = str(uns_dir() / f"arm_{ny_}x{nt_}.inp")
    torque_arm.synthesize_arm_inp(yinp, nr=ny_, nt=nt_)
    yard = uns_yardstick(torque_arm.arm_model(yinp, device=dev)[0],
                         "arm yardstick")

    # the topology loop at full width, one cached structural set-up
    prob, tm, tf, _c, _X = torque_arm_topo.build_problem(inp, device=dev)
    share_pattern(tm, model)
    topo = uns_topo(prob, tm, tf, "arm topo", UNS_TOPO_WARMUP,
                    UNS_TOPO_ITERS)
    return dict(ndof=model.ndof, nelems=model.nelems, solve=st,
                res=res, second=dict(st2, res=res2),
                f32_precond=dict(stf, res=resf), translations=int(kt),
                breakdown=brk, f32=dict(st32, res=res32, res_own=own32,
                                        floor=floor32), yard=yard,
                topo=topo, U1=k1, U2=k2, synth_s=t_syn, parse_s=t_parse,
                pattern_s=t_pat, segments_s=t_seg, native_s=t_lib,
                system=(K, b, model.X_host))


def uns_bracket_line(dev, pt, rng):
    """The bracket line of phase 11 (see :func:`phase_unstructured`)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import unstructured as pu
    from pyfem_gpu_testflight_tpu_torch.examples import bracket3d_topo

    n = UNS_BRACKET_N
    t0 = time.time()
    inp = str(uns_dir() / f"bracket_{n}.inp")
    bracket3d_topo.synthesize_bracket_inp(inp, n=n)
    t_syn = time.time() - t0
    t0 = time.time()
    model, X, conn = bracket3d_topo.bracket_model(
        inp, device=dev, dtype=torch.float32, kernel="cuda")
    model.amg_options = {"max_offsets": UNS_BRACKET_OFFSETS}
    t_parse = time.time() - t0
    log(f"bracket: n={n}, {model.nnodes} nodes, {model.nelems} C3D10 "
        f"elements, {model.ndof} dof; .inp written in {t_syn:.2f} s, parsed "
        f"+ model in {t_parse:.2f} s")
    check(model.ndof == 212355 and model.nelems == 49152,
          "bracket: 212,355 dof, 49,152 tet10 elements")
    u, st = uns_solve(model, "bracket float32", 1e-6)
    # K8 against its plain version at the path's shape (49,152 distorted
    # tet10 elements, rho = 1)
    run_k, run_p, _ins = stiffness_pair(
        model, "tet10", "elasticity",
        torch.ones(model.nnodes, dtype=torch.float32, device=dev))
    k8a, k8r = rel_err(run_k(), run_p())
    check(k8r <= REL_TOL, f"bracket: K8 tet10 on the path's elements within "
          f"{REL_TOL:g} of plain (rel {k8r:.2e})")
    del _ins
    brk, amg = amg_breakdown(model, "bracket float32", rng)
    check(st["counts"]["pyfem_stiffness_3d"] == 1
          and st["counts"]["pyfem_csr_spmv"] > 0,
          "bracket: K8 launched once and U1 on the main path")
    K, b = model.bc.apply_scipy(
        model.assemble_scipy(model.element_jacobian(1.0)),
        model.compute_rhs().cpu().numpy())
    own, floor = f32_check(K, b, u, 1e-6, "bracket float32")
    # the float64 true residual the float32 solve reaches on the float64
    # (einsum) operator: K8's float32 Ke differ from it (the kernel's
    # documented ~2 digits on quadratic elements)
    m64 = bracket3d_topo.bracket_model(inp, device=dev)[0]
    share_pattern(m64, model)
    K64, b64 = m64.bc.apply_scipy(
        m64.assemble_scipy(m64.element_jacobian(1.0)),
        m64.compute_rhs().cpu().numpy())
    del m64
    res = true_residual(K64, b64, u)
    log(f"bracket float32: float64 true residual on the float64 operator "
        f"{res:.3e}")
    xt, kt, _ = pu.amg_pcg(K, b, nd=3, rtol=1e-6, device=dev,
                           max_offsets=UNS_BRACKET_OFFSETS)
    log(f"bracket: rigid-body modes {st['iters']} iterations, "
        f"translations only {int(kt)}")
    check(st["iters"] < int(kt), "bracket: rigid-body modes beat "
          "translations")
    del xt, K64, b64
    k1 = dict(max_abs_err=u1_check_levels(amg, "bracket", rng))
    fine = amg.levels[0]["op"]
    k1["f32"] = u1_timed(fine, torch.float32, rng, "bracket fine level")
    k1["f64"] = u1_timed(fine, torch.float64, rng, "bracket fine level")
    del amg, K, b

    # yardstick: float64 einsum model at n = 17 against SuperLU
    ny_ = UNS_BRACKET_YARD_N
    yinp = str(uns_dir() / f"bracket_{ny_}.inp")
    bracket3d_topo.synthesize_bracket_inp(yinp, n=ny_)
    yard = uns_yardstick(bracket3d_topo.bracket_model(yinp, device=dev)[0],
                         "bracket yardstick")
    prob, tm, tf, _c, _X = bracket3d_topo.build_problem(yinp, device=dev)
    topo = uns_topo(prob, tm, tf, "bracket topo n=17", 0,
                    UNS_BRACKET_TOPO_ITERS)
    return dict(ndof=model.ndof, nelems=model.nelems, solve=st, res=res,
                res_own=own, floor=floor, k8_err=k8a,
                translations=int(kt), breakdown=brk, yard=yard, topo=topo,
                U1=k1, synth_s=t_syn, parse_s=t_parse)


def u2_bench_grid(dev, pt, rng):
    """U2 on the 2D bench grid: ``structured_dia_2d(1025, 513, 2)`` (21
    diagonals) assembled by ``StructuredDia2D`` from the bench model's
    float64 element matrices, as the operator of a Jacobi-PCG solve
    (``DiaOperator.bc_matvec``, rtol 1e-6) — U2's run: the counts zeroed
    before, read after, the solution's true residual by the matrix-free
    operator — then U2 against plain (both forms) and timed in
    float32."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import assembly, solvers
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import structured_dia_2d

    conn, X, fixed, force, _L = problem(NX, NY)
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            device=dev)
    Ke = m.element_jacobian(1.0)
    op, st = structured_dia_2d(NX, NY, 2)
    dia = st.assemble(Ke)
    mask = m.bc.mask
    b = m.bc.constrain_rhs(m.compute_rhs(), lambda v: m.matvec(Ke, v))
    diag = op.diagonal(dia)
    inv_diag = 1.0 / torch.where(mask | (diag == 0), 1.0, diag)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.time()
    res = solvers.cg(lambda d, u: op.bc_matvec(d, mask, u), dia, b,
                     inv_diag=inv_diag, rtol=1e-6, maxiter=20000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    launches = _cuda.launches["pyfem_dia_spmv"]
    yt = assembly.bc_elem_matvec((Ke, m.conn_dof, mask, m.segments), res.x)
    tr = float(torch.linalg.norm(b - yt) / torch.linalg.norm(b))
    log(f"U2 bench 2D: {op.noffs} diagonals, Jacobi-PCG on "
        f"DiaOperator.bc_matvec (float64): {int(res.iters)} iterations in "
        f"{t_cg:.2f} s, {launches} U2 launches, true residual (matrix-free "
        f"operator) {tr:.3e}")
    blocks = -(-int(res.iters) // solvers.CHECK_EVERY)
    check(launches == solvers.CHECK_EVERY * blocks and tr <= 2e-6,
          f"U2 bench 2D: one U2 launch per CG iteration of its "
          f"{blocks} blocks of {solvers.CHECK_EVERY} and the solution's "
          f"true residual <= 2e-6")
    u = torch.as_tensor(rng.standard_normal(op.ndof), device=dev)
    r64m = u2_timed(op, dia, u, "U2 bench 2D float64 masked", mask=mask)
    d32, u32 = dia.float(), u.float()
    csr = dia_to_csr(op, d32)
    r32 = u2_timed(op, d32, u32, "U2 bench 2D float32", csr_op=csr)
    return dict(r32, launches=launches, cg_iters=int(res.iters),
                cg_s=t_cg, true_res=tr,
                max_abs_err=max(r32["max_abs_err"], r64m["max_abs_err"]),
                f64_masked=r64m)


def dia_to_csr(op, dia):
    """A DIA matrix (``dia[k, i]`` at (i, i + offsets[k])) as the port's
    device CSR: the input of the ``torch.sparse`` yardstick."""
    from scipy import sparse
    from pyfem_gpu_testflight_tpu_torch import unstructured as pu

    d = dia.double().cpu().numpy()
    n = op.ndof
    rows, cols, vals = [], [], []
    for k, off in enumerate(op.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(d[k, i])
    A = sparse.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                  np.concatenate(cols))),
                          shape=(n, n))
    return pu._device_csr(A, {}, "p", dia.dtype, dia.device)[0]


def phase_unstructured(dev, pt):
    """Phase 11: unstructured meshes on the card.  The arm line: the
    synthesized torque arm at 257x2049 polar nodes (1,053,186 dof, tri3)
    written as .inp, parsed, ``LinearElasticity`` in float64,
    ``solve(method="amg", rtol=1e-10)`` (the main path: U1 counted),
    its true residual on the host, a second solve at another density
    (no structural set-up, the same runner), a float32 V-cycle under the
    float64 CG, translations-only against rigid-body modes, the solve in
    parts (set-ups, PCG, V-cycle, busy share), a float32 model at rtol
    1e-6, the 129x1025 arm against SuperLU, and the topology loop at full
    width (2 + 5 MMA iterations, one structural set-up).  The bracket
    line: C3D10 at n=33 (212,355 dof) on K8 (``kernel="cuda"``, float32)
    and float32 AMG-PCG to rtol 1e-6, its float64 true residual, the
    modes, the parts, the n=17 float64 bracket against SuperLU and its
    topology loop (4 MMA iterations).  U1 against plain on every level
    of both lines in float32 and float64, with times on each fine level;
    U2 on the arm's fine matrix as DIA and on the 2D bench grid."""
    rng = np.random.default_rng(SEED + 11)
    t0 = time.time()
    arm = uns_arm_line(dev, pt, rng)
    t_arm = time.time() - t0
    t0 = time.time()
    bracket = uns_bracket_line(dev, pt, rng)
    t_br = time.time() - t0
    t0 = time.time()
    grid = u2_bench_grid(dev, pt, rng)
    log(f"phase 11: arm line {t_arm:.1f} s, bracket line {t_br:.1f} s, "
        f"U2 bench grid {time.time() - t0:.1f} s")
    return dict(arm=arm, bracket=bracket, u2_grid=grid,
                seconds=dict(arm=t_arm, bracket=t_br))


def unstructured_kernel_rows(uns):
    """The kernels line's U1 and U2 rows from phase 11."""
    src = "pyfem_gpu_testflight_tpu_torch/csrc/spmv.cu"
    arm, br, grid = uns["arm"], uns["bracket"], uns["u2_grid"]
    f32 = arm["U1"]["f32"]
    keep = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "n", "nnz", "l2_flushed")
    u1 = dict(
        name="csr_spmv", route="cuda", source=src,
        replaces="none (the JAX AMG levels are DIA: "
                 "pyfem_gpu_testflight_tpu/ops/dia.py:130 matvec, plain XLA)",
        launches=arm["solve"]["counts"]["pyfem_csr_spmv"],
        max_abs_err=max(arm["U1"]["max_abs_err"], br["U1"]["max_abs_err"]),
        ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_us=1e3 * f32["bound_ms"], bound_by=f32["bound_by"],
        library_ms=f32["library_ms"], device_ms=f32["device_ms"],
        form="a group of lanes per row (a power of two about an eighth of "
             "the mean row length), shuffle-reduced in a fixed order (main "
             "path: the "
             "1,053,186-dof arm's float64 AMG-PCG; timed form: its fine "
             "level in float32)",
        launches_bracket=br["solve"]["counts"]["pyfem_csr_spmv"],
        forms={"arm_f64": {k: arm["U1"]["f64"][k] for k in keep},
               "bracket_f32": {k: br["U1"]["f32"][k] for k in keep},
               "bracket_f64": {k: br["U1"]["f64"][k] for k in keep}})
    a2 = arm["U2"]
    u2 = dict(
        name="dia_spmv", route="cuda", source=src,
        replaces="none (DiaOperator.matvec: "
                 "pyfem_gpu_testflight_tpu/ops/dia.py:130, plain XLA)",
        launches=grid["launches"], max_abs_err=max(grid["max_abs_err"],
                                                   a2["max_abs_err"]),
        ms=grid["ms"], plain_ms=grid["plain_ms"], bound_ms=grid["bound_ms"],
        bound_us=1e3 * grid["bound_ms"], bound_by=grid["bound_by"],
        library_ms=grid["library_ms"], device_ms=grid["device_ms"],
        form="one thread per row, offsets staged in shared memory (main "
             "path: Jacobi-PCG on DiaOperator.bc_matvec on the 2D bench "
             "grid, float64; timed form: that grid's 21 diagonals in "
             "float32)",
        forms={"arm_fine_f32": {k: a2[k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "noffs", "n")}})
    return [u1, u2]


def unstructured_summary(uns):
    """Phase 11's figures as one JSON-able dict."""
    arm, br = uns["arm"], uns["bracket"]
    line = lambda o: dict(
        ndof=o["ndof"], iters=o["solve"]["iters"],
        solve_s=o["solve"]["wall_s"], mem=o["solve"]["mem"],
        res=o["res"], translations=o["translations"],
        breakdown=o["breakdown"], yard=o["yard"],
        topo=dict(s_per_iter=o["topo"]["s_per_iter"],
                  stages=o["topo"]["stages"],
                  state_iters=[s[0] for s in o["topo"]["state"]],
                  objs=(o["topo"]["objs"][0], o["topo"]["objs"][-1])))
    out = dict(arm=line(arm), bracket=line(br), seconds=uns["seconds"])
    out["arm"].update(second=dict(iters=arm["second"]["iters"],
                                  res=arm["second"]["res"],
                                  setup_s=arm["second"]["setup_s"]),
                      f32_precond=dict(iters=arm["f32_precond"]["iters"],
                                       res=arm["f32_precond"]["res"]),
                      f32=dict(iters=arm["f32"]["iters"],
                               res=arm["f32"]["res"],
                               res_own=arm["f32"]["res_own"],
                               floor=arm["f32"]["floor"]),
                      pattern_s=arm["pattern_s"])
    out["bracket"].update(res_own=br["res_own"], floor=br["floor"])
    return out


def run_unstructured():
    """``python3 chip_smoke.py --unstructured``: only phase 11 (with the
    kernel build); prints the card, the kernels line of U1 and U2 and
    one JSON line of its figures."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    log(card_line())
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    uns = phase_unstructured(torch.device("cuda", 0), pt)
    log(json.dumps(unstructured_summary(uns)))
    log(json.dumps({"kernels": unstructured_kernel_rows(uns)}))
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    return 0


# -- phase 12: the user-facing surface -------------------------------------

SURF_SEED = SEED + 12
SURF_P = 3.0
SURF_PVAL = 10.0       # KS aggregation parameter of the adjoint chain
SURF_YARD = (257, 129)  # complex-step gradient and host eigsh grid
# natural_frequencies_device: grids tried from 129x65 down (the first
# one meeting rtol 1e-6 against eigsh within maxiter=200 is reported)
SURF_EIG_GRIDS = ((129, 65), (65, 33), (33, 17), (17, 9))
SURF_EIG_RTOL = 1e-6
SURF_MASS_TOL = 1e-5   # float32 lumped-mass sum against density*area*nd
SURF_EXAMPLES = (
    ("block_3d", ("--vtk", "{d}/block.vtk")),
    ("heat_conduction", ("--vtk", "{d}/heat.vtk")),
    ("helmholtz_filter", ("--vtk", "{d}/helmholtz.vtk")),
    ("nonlinear_poisson_ex", ("--vtk", "{d}/nonlinear_poisson.vtk")),
    ("quad_tri", ("--out-dir", "{d}")),
    ("element_plot", ("--out-dir", "{d}")),
    ("topo", ("--solver", "gmg", "--max_iterations", "3", "--prefix",
              "{d}/topo")),
    ("performance_study", ("--kernel", "cuda")),
)
SURF_NAMES = ("pyfem_assemble_2d", "pyfem_smooth_2d", "pyfem_sweeps_2d",
              "pyfem_stencil_2d", "pyfem_stiffness_3d")


def surf_gmg_options():
    """bench 2D's GMG options (bench.py run_2d), as
    ``attach_structured_grid`` takes them."""
    import torch

    return dict(nu_pre=2, nu_post=2, min_n=5, coarse_dense_max=4096,
                smoother_dtype=torch.bfloat16, omega="cheby")


def surf_counts():
    """The phase's kernel launch counts since the last reset (K2 as the
    sum of its entries)."""
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    c = {k: _cuda.launches.get(k, 0) for k in SURF_NAMES}
    c["K2"] = k2_launches(c)
    return c


def grad_floor(model, u):
    """max over quadrature points of sum_n |grad N_n| |u_n| (each
    component pair), the scale of a float32 strain's rounding: a strain
    computed in float32 is off by a few u32 times it."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import geometry

    _, Ng = geometry.shape_gradients(model.Xe.double(), model.dN.double())
    nd = model.ndof_per_node
    ue = u.double()[model.conn_dof].reshape(model.nelems,
                                            model.nnodes_per_elem, nd).abs()
    S = torch.einsum("eqnl,ena->eqal", Ng.abs(), ue)
    return float((S + S.transpose(-1, -2)).max())


def surface_elasticity(dev, pt, multigrid, i2p, p2i):
    """12a + 12d: the 1025x513 cantilever through Assembler.solve and the
    post-processing functions, each stage under ``time_this`` with CUDA
    events inside it; returns the counts and readings."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import postprocess as post
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.utils import profile

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                                p=SURF_P, dtype=torch.float32, device=dev)
    model.attach_structured_grid(NX, NY, **surf_gmg_options())
    rho = np.random.default_rng(SURF_SEED).uniform(0.3, 1.0, model.nnodes)
    rho_t = torch.as_tensor(rho, dtype=torch.float32, device=dev)
    asm = pt.Assembler(model)
    solve = lambda: asm.solve(method="gmg", rtol=1e-6, rho=rho_t)
    u = solve()
    stages = (
        ("solve", solve),
        ("quadrature_strains", lambda: post.quadrature_strains(model, u)),
        ("quadrature_stresses",
         lambda: post.quadrature_stresses(model, u, rho_t)),
        ("nodal_strains", lambda: post.nodal_strains(model, u)),
        ("mass_matrix", lambda: post.mass_matrix(model, density=2.5)),
        ("lumped_mass", lambda: post.lumped_mass(model, density=2.5)),
    )
    # warm-up: allocator, hierarchy statics, the sorted segments (built
    # on first use), first-call library set-up; the cold times are kept
    cold = {}
    for name, fn in stages:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        cold[name] = 1e3 * (time.perf_counter() - t0)
    log("surface 12a first (cold) calls, host clock ms: " + ", ".join(
        f"{n} {v:.1f}" for n, v in cold.items()))
    profile.timer_on()
    profile.timer_to_stdout()
    profile.timer_set_threshold(0.0)
    profile.saved_times.clear()
    out, ev_ms, mem = {}, {}, {}
    counts = None
    try:
        for name, fn in stages:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))

            def run(fn=fn, ev=ev):
                ev[0].record()
                r = fn()
                ev[1].record()
                return r

            run.__qualname__ = f"surface.{name}"
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if name == "solve":
                _cuda.reset_launches()
            out[name] = profile.time_this(run)()
            if name == "solve":
                counts = surf_counts()
                k = model.last_solve_stats["iters"]
            mem[name] = torch.cuda.max_memory_allocated() - base
            ev_ms[name] = ev[0].elapsed_time(ev[1])
            if name == "solve":
                u = out["solve"]
    finally:
        profile.timer_off()
    timer_ms = {n.split(".", 1)[1]: v[-1]
                for n, v in profile.saved_times.items()
                if n.startswith("surface.")}
    for name, _ in stages:
        log(f"surface 12a {name}: {ev_ms[name]:.3f} ms (CUDA events), "
            f"timer {timer_ms.get(name, float('nan')):.3f} ms, peak "
            f"memory {mem[name] / 2**20:.1f} MiB above the allocated")
    log(f"surface 12a: {model.ndof} dof, {k} PCG iterations, launches "
        f"{counts}")
    # 12d: every stage kept, each timer reading >= its device span
    check(set(timer_ms) == {n for n, _ in stages},
          "surface 12d: saved_times holds every stage")
    check(all(timer_ms[n] >= ev_ms[n] for n, _ in stages if n in timer_ms),
          "surface 12d: each timer reading >= the stage's CUDA-event time "
          "(the timer synchronizes)")

    # phase 4's configuration (bench2d's step) at this p and density
    _m4, _asm4, _r4, rhs4, step4, _L = bench2d(dev, pt, multigrid, i2p, p2i,
                                               p=SURF_P)
    (u4, k4, _rn4, _b4, gmg4), c4, _ms4 = solve_and_measure(
        step4, (rho_t, rhs4, rhs4), SURF_NAMES, "surface 12a phase-4 step")
    c4["K2"] = k2_launches(c4)
    log(f"surface 12a phase-4 step: {k4} iterations, launches {c4}")
    # the model's solve starts its correction from 0, as the step does:
    # the same launches
    check(k == k4 and counts["pyfem_assemble_2d"] == c4["pyfem_assemble_2d"]
          == len(gmg4.levels) and counts["K2"] == c4["K2"],
          f"surface 12a: iterations ({k} vs {k4}), K1 ({counts['pyfem_assemble_2d']}"
          f" vs {c4['pyfem_assemble_2d']}) and K2 ({counts['K2']} vs "
          f"{c4['K2']}) equal phase 4's step")
    du = float((u - u4).abs().max() / u4.abs().max())
    check(du == 0.0, f"surface 12a: the solution equals the phase-4 step's "
          f"bit for bit (max rel diff {du:.3e})")
    del _m4, _asm4, gmg4, u4

    # float32 against float64 on the same u
    m64 = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                              p=SURF_P, dtype=torch.float64, device=dev)
    u64 = u.double()
    S = grad_floor(m64, u64)
    cs = 2.0 * model.mu + abs(model.lam)
    errs = {}
    for name, fn, args, scale in (
            ("quadrature_strains", post.quadrature_strains, (), 1.0),
            ("quadrature_stresses", post.quadrature_stresses, (rho_t,), cs),
            ("nodal_strains", post.nodal_strains, (), 1.0)):
        ref = fn(m64, u64, *args)
        got = out[name]
        check(got.dtype == torch.float32 and got.shape == ref.shape
              and bool(torch.isfinite(got).all()),
              f"surface 12a {name}: float32, finite, shape "
              f"{tuple(ref.shape)}")
        err = float((got.double() - ref).abs().max())
        errs[name] = dict(
            rel=err / float(ref.abs().max()),
            floor_ratio=err / (2.0 ** -24 * scale * S))
        log(f"surface 12a {name}: float32 vs float64 max-abs "
            f"{err:.3e} (rel to max {errs[name]['rel']:.3e}), "
            f"{errs[name]['floor_ratio']:.2f} x the rounding scale")
        check(errs[name]["floor_ratio"] <= FLOOR_FACTOR,
              f"surface 12a {name}: float32 within {FLOOR_FACTOR:g} x "
              f"u32 x max(sum |grad N| |u|) of float64")
    del m64
    area = float(np.ptp(X[:, 0]) * np.ptp(X[:, 1]))
    msum = float(out["lumped_mass"].double().sum())
    check(abs(msum / (2.5 * area * 2) - 1.0) <= SURF_MASS_TOL,
          f"surface 12a: lumped mass sums to density x area x nd "
          f"({msum:.7f} vs {2.5 * area * 2:.7f})")
    check(tuple(out["mass_matrix"].shape) == (model.nelems, 8, 8),
          "surface 12a: element mass matrices (nelems, 8, 8)")

    # an exact affine field: constant strains at every quad and node
    A = np.array([[2e-3, 1e-3], [-5e-4, 3e-3]])
    ua = torch.as_tensor((X @ A.T).reshape(-1), dtype=torch.float32,
                         device=dev)
    exact = torch.tensor([A[0, 0], A[1, 1], A[0, 1] + A[1, 0]],
                         dtype=torch.float64, device=dev)
    Sa = grad_floor(model, ua)
    for fn in (post.quadrature_strains, post.nodal_strains):
        err = float((fn(model, ua).double() - exact).abs().max())
        log(f"surface 12a affine field {fn.__name__}: max-abs error "
            f"{err:.3e}, {err / (2.0 ** -24 * Sa):.2f} x the rounding scale")
        check(err <= FLOOR_FACTOR * 2.0 ** -24 * Sa,
              f"surface 12a affine field: {fn.__name__} exact to "
              f"{FLOOR_FACTOR:g} x u32 x max(sum |grad N| |u|)")
    return dict(counts=counts, iters=k, ev_ms=ev_ms, timer_ms=timer_ms,
                mem=mem, errs=errs, ndof=model.ndof, cold=cold)


def poisson_model(pt, dev, nx, ny, dtype, p=SURF_P):
    import torch

    conn, X, fixed = pt.ProblemCreator(nx, ny).create_poisson_problem()
    return pt.LinearPoisson("quad4", X, conn, fixed, p=p, dtype=dtype,
                            device=dev,
                            gfunc=lambda x: torch.ones_like(x[..., 0]))


def surface_ks(dev, pt):
    """12b: KS, its adjoint rhs, the gmg adjoint solve and the design
    gradient on the 1025x513 Poisson model (K1/K2 at nd=1); the adjoint's
    float64 true residual; the complex-step gradient at 257x129."""
    import torch
    from scipy.sparse.linalg import spsolve
    from pyfem_gpu_testflight_tpu_torch import assembly
    from pyfem_gpu_testflight_tpu_torch import postprocess as post
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    m = poisson_model(pt, dev, NX, NY, torch.float32)
    m.attach_structured_grid(NX, NY, **surf_gmg_options())
    rho = torch.as_tensor(
        np.random.default_rng(SURF_SEED + 1).uniform(0.3, 1.0, m.nnodes),
        dtype=torch.float32, device=dev)
    asm = pt.Assembler(m)

    def chain():
        u = asm.solve(method="gmg", rtol=1e-6, rho=rho)
        ks = [post.ks_aggregate(m, u, pv) for pv in (SURF_PVAL, 100.0)]
        b = m.bc.zero_fixed(post.ks_adjoint_rhs(m, u, SURF_PVAL))
        psi = post.solve_adjoint(m, b, rho=rho, method="gmg", rtol=1e-6)
        k_adj = m.last_solve_stats["iters"]
        grad = -m.k_dv_sens(rho, psi, u)
        return u, ks, b, psi, k_adj, grad

    chain()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    u, ks, b, psi, k_adj, grad = chain()
    e1.record()
    e1.synchronize()
    counts = surf_counts()
    ms = e0.elapsed_time(e1)
    umax = float(u.max())
    ks10, ks100 = (float(v) for v in ks)
    log(f"surface 12b: {m.ndof} dof, KS(10) {ks10:.6e}, KS(100) "
        f"{ks100:.6e}, max u {umax:.6e}; adjoint {k_adj} iterations; "
        f"solve + KS + adjoint + gradient {ms:.3f} ms (CUDA events); "
        f"launches {counts}")
    check(abs(ks100 - umax) < abs(ks10 - umax),
          "surface 12b: KS nears max(u) as pval grows")
    check(counts["pyfem_assemble_2d"] > 0 and counts["K2"] > 0,
          "surface 12b: K1 and K2 (nd=1) launched")
    check(bool(torch.isfinite(grad).all()) and grad.shape == (m.nnodes,),
          "surface 12b: design gradient finite, shape (nnodes,)")
    # the adjoint's float64 true residual against its float32 floor
    m64 = poisson_model(pt, dev, NX, NY, torch.float64)
    Ke = m64.element_jacobian(rho)
    mask = m64.bc.mask
    op = lambda K, v: assembly.bc_elem_matvec(
        (K, m64.conn_dof, mask, m64.segments), v)
    b64, psi64 = b.double(), psi.double()
    bn = float(torch.linalg.norm(b64))
    true = float(torch.linalg.norm(b64 - op(Ke, psi64))) / bn
    floor = 2.0 ** -24 * float(torch.linalg.norm(op(Ke.abs(),
                                                     psi64.abs()))) / bn
    log(f"surface 12b adjoint: float64 true residual {true:.3e}, float32 "
        f"floor {floor:.3e} (ratio {true / floor:.2f})")
    check(true <= FLOOR_FACTOR * floor,
          f"surface 12b adjoint: true residual <= {FLOOR_FACTOR:g} x "
          f"float32 floor")
    del m64, Ke

    # the complete KS design gradient against a complex step (float64,
    # direct solves), as tests/test_postprocess.py holds the JAX package
    nx, ny = SURF_YARD
    my = poisson_model(pt, dev, nx, ny, torch.float64)
    rng = np.random.default_rng(SURF_SEED + 2)
    rho_y = rng.uniform(0.3, 1.0, my.nnodes)
    pvec = rng.uniform(0.0, 1.0, my.nnodes)
    _, uy = my.compliance(rho_y, solver="direct")
    dks = post.ks_adjoint_rhs(my, uy, SURF_PVAL)
    psi_y = post.solve_adjoint(my, my.bc.zero_fixed(dks), rho=rho_y,
                               method="direct")
    g = -my.k_dv_sens(rho_y, psi_y, uy).cpu().numpy()
    h = 1e-30
    K = my.compute_jacobian(rho_y + 1j * h * pvec)
    Kbc, rhsbc = my.bc.apply_scipy(K, my.compute_rhs().cpu().numpy())
    fd = complex(post.ks_aggregate(my, spsolve(Kbc, rhsbc),
                                   SURF_PVAL)).imag / h
    cs_err = abs(pvec.dot(g) - fd) / abs(fd)
    log(f"surface 12b complex step at {nx}x{ny}: directional derivative "
        f"{pvec.dot(g):.15e} vs {fd:.15e}, rel {cs_err:.3e}")
    check(cs_err < 1e-12, "surface 12b: KS design gradient = complex step "
          "to 1e-12")
    return dict(counts=counts, ms=ms, true=true, floor=floor,
                cs_err=cs_err, ndof=m.ndof)


def surface_eigen(dev, pt):
    """12c: natural_frequencies_device (float64, einsum elements) against
    host eigsh on the same lumped mass, from 129x65 down to the first
    grid meeting rtol 1e-6; natural_frequencies (host shift-invert) at
    257x129 with the Rayleigh-quotient check."""
    import torch
    from scipy.sparse import diags, linalg as sla
    from pyfem_gpu_testflight_tpu_torch import postprocess as post

    found = None
    tried = []
    for nx, ny in SURF_EIG_GRIDS:
        conn, X, fixed, force, _L = problem(nx, ny)
        m = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                                dtype=torch.float64, device=dev)
        K = m.assemble_scipy(m.element_jacobian())
        ml = post.lumped_mass(m).cpu().numpy()
        free = np.setdiff1d(np.arange(m.ndof), m.bc.fixed)
        ref, _ = sla.eigsh(K[free][:, free].tocsc(),
                           M=diags(ml[free]).tocsc(), k=4, sigma=0.0,
                           which="LM")
        ref = np.sqrt(np.maximum(np.sort(ref), 0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, modes = post.natural_frequencies_device(m, k=4)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        err = float(np.abs(w.cpu().numpy() / ref - 1.0).max())
        st = m.last_eig_stats
        tried.append(dict(grid=f"{nx}x{ny}", ndof=m.ndof, rel=err,
                          s=dt, **st))
        log(f"surface 12c LOBPCG {nx}x{ny} ({m.ndof} dof): rel error "
            f"{err:.3e} against eigsh, {st['iters']} iterations, "
            f"{st['applies']} operator applications ({st['columns']} "
            f"columns), {dt:.3f} s host clock")
        if err <= SURF_EIG_RTOL:
            found = tried[-1]
            check(float(modes[m.bc.mask].abs().max()) == 0.0,
                  "surface 12c: LOBPCG modes zero at fixed dofs")
            break
    check(found is not None, f"surface 12c: natural_frequencies_device "
          f"meets rtol {SURF_EIG_RTOL:g} against eigsh on some grid")
    if found:
        log(f"surface 12c: largest grid meeting rtol {SURF_EIG_RTOL:g}: "
            f"{found['grid']} ({found['ndof']} dof)")
    nx, ny = SURF_YARD
    conn, X, fixed, force, _L = problem(nx, ny)
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                            dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    w, modes = post.natural_frequencies(m, k=4)
    dt = time.perf_counter() - t0
    K = m.assemble_scipy(m.element_jacobian())
    M = m.assemble_scipy(post.mass_matrix(m))
    v = modes[:, 0]
    rq = float(np.sqrt((v @ (K @ v)) / (v @ (M @ v))))
    log(f"surface 12c natural_frequencies {nx}x{ny}: omega "
        f"{np.array2string(w, precision=6)}, Rayleigh quotient of mode 0 "
        f"{rq:.9e}, {dt:.2f} s host clock")
    check(bool(np.all(w > 0)) and bool(np.all(np.diff(w) >= -1e-9))
          and float(np.abs(modes[m.bc.fixed]).max()) < 1e-12
          and abs(rq / w[0] - 1.0) <= 1e-5,
          "surface 12c: host frequencies positive, sorted, modes zero at "
          "fixed dofs, Rayleigh quotient within 1e-5")
    return dict(found=found, tried=tried, host_s=dt)


def surface_examples(dev):
    """12e: every ported example's main once on the card at its default
    size (topo: --solver gmg, 3 MMA iterations), its VTK output in a
    temporary directory and its printout in build/chip_smoke/; K1, K2
    and K9 launches of topo and K8's of performance_study."""
    import contextlib
    import importlib
    import io
    import tempfile

    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, args in SURF_EXAMPLES:
            argv = [a.format(d=d) for a in args] + ["--device", dev.type]
            mod = importlib.import_module(
                f"pyfem_gpu_testflight_tpu_torch.examples.{name}")
            buf = io.StringIO()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    mod.main(argv)
                torch.cuda.synchronize()
                rc = 0
            except Exception as exc:  # the phase reports, then fails
                rc = f"{type(exc).__name__}: {exc}"
            dt = time.perf_counter() - t0
            out[name] = dict(rc=rc, s=dt, counts=surf_counts())
            (uns_dir() / f"example_{name}.log").write_text(buf.getvalue())
            log(f"surface 12e example {name}: exit {rc}, {dt:.2f} s host "
                f"clock, launches {out[name]['counts']}")
            check(rc == 0, f"surface 12e: example {name} exits with 0")
    ct = out["topo"]["counts"]
    check(ct["pyfem_assemble_2d"] > 0 and ct["K2"] > 0
          and ct["pyfem_stencil_2d"] > 0,
          "surface 12e: topo runs K1, K2 and K9")
    check(out["performance_study"]["counts"]["pyfem_stiffness_3d"] > 0,
          "surface 12e: performance_study --kernel cuda runs K8")
    return out


def phase_surface(dev, pt, multigrid, i2p, p2i):
    """Phase 12 (see the module docstring)."""
    t0 = time.time()
    res = dict(elasticity=surface_elasticity(dev, pt, multigrid, i2p, p2i))
    res["ks"] = surface_ks(dev, pt)
    res["eigen"] = surface_eigen(dev, pt)
    res["examples"] = surface_examples(dev)
    log(f"surface: phase 12 took {time.time() - t0:.1f} s host clock")
    return res


def surface_summary(res):
    a, b, c = res["elasticity"], res["ks"], res["eigen"]
    return dict(
        elasticity=dict(ndof=a["ndof"], iters=a["iters"],
                        launches=a["counts"], ms=a["ev_ms"],
                        cold_host_ms=a["cold"],
                        timer_ms=a["timer_ms"],
                        peak_mib={k: v / 2**20 for k, v in a["mem"].items()},
                        f32_vs_f64=a["errs"]),
        ks=dict(ndof=b["ndof"], launches=b["counts"], chain_ms=b["ms"],
                adjoint_true=b["true"], adjoint_floor=b["floor"],
                complex_step_rel=b["cs_err"]),
        eigen=dict(found=c["found"], tried=c["tried"], host_s=c["host_s"]),
        examples={k: dict(rc=v["rc"], s=v["s"], launches=v["counts"])
                  for k, v in res["examples"].items()},
    )


def run_surface():
    """``python3 chip_smoke.py --surface``: only phase 12 (with the kernel
    build); prints the card and one JSON line of its readings."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )

    log(card_line())
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    res = phase_surface(torch.device("cuda", 0), pt, multigrid, i2p, p2i)
    log(json.dumps({"surface": surface_summary(res)}))
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    return 0


# -- phase 13: multi-rank solvers over torch.distributed ---------------------

SH_TOPO = (2, 3)        # 13a 2D ShardedDeviceTopo: warm-up, timed MMA its
SH_TOPO3D_N = 33        # 13a 3D: 65x33x33, bench topo --topo-3d's width
SH_TOPO3D = (2, 5)
SH_TIMEOUT = 900.0      # 13b and 13c: seconds before the ranks are ended
SH_DEVICE = None        # 13b/13c ranks' device: None, the card
# 13a: the sharded topology loops against the single-device DeviceTopo on
# the same options: the same kernels assemble every level and the same PCG
# form solves, so they part by the order of the reductions.  Held: the
# design iterates (relative L2 of the last) and the state PCG iterations
# (within 1 each).  The compliances are read, not held: a float32 state
# solve stops at its operator's rounding floor, where one ulp of density
# moves the compliance by 1.5e-3 at 65x33 (CPU), and at 1025x513 either
# route's float32 compliance is ~40% off the float64 one (ROADMAP queue 3
# item 2)
SH_TOPO_X_TOL = 2e-2
# the first iteration's compliance (both loops start from the same
# design), held: read 3.9e-4 (2D) and 7e-6 (3D) apart on an H100 (PERF.md)
SH_TOPO_OBJ0_TOL = 2e-3
# 13b: two ranks' solutions against 13a's world-1 ones (rel L2)
SH_W2_REL = {"2d": 1e-3, "3d": 1e-3, "arm": 1e-9}
SH_NAMES = ("pyfem_assemble_2d", "pyfem_smooth_2d", "pyfem_sweeps_2d",
            "pyfem_assemble_3d", "pyfem_sweep_3d", "pyfem_sweeps_3d",
            "pyfem_stencil_2d", "pyfem_csr_spmv")


def sh_counts():
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    c = {k: _cuda.launches.get(k, 0) for k in SH_NAMES}
    c["K2"] = k2_launches(c)
    return c


def k4_per_pass(run):
    """One more run of ``run`` with every ``fused_sweep_3d`` call and
    every K4 launch counted: (calls, launches)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth

    calls = [0]
    sweep = fused_smooth.fused_sweep_3d

    def counting(*a, **kw):
        calls[0] += 1
        return sweep(*a, **kw)

    fused_smooth.fused_sweep_3d = counting
    n0 = _cuda.launches["pyfem_sweep_3d"]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        fused_smooth.fused_sweep_3d = sweep
    return calls[0], _cuda.launches["pyfem_sweep_3d"] - n0


class world1_nccl:
    """A world-1 NCCL process group for the ``with`` block (a FileStore
    in a fresh directory; destroyed on the way out)."""

    def __enter__(self):
        import datetime
        import tempfile

        import torch.distributed as dist

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
        dist.init_process_group(
            "nccl", init_method=f"file://{self.dir}/store", rank=0,
            world_size=1, timeout=datetime.timedelta(seconds=300))
        return self

    def __exit__(self, *exc):
        import shutil

        import torch.distributed as dist

        dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)
        return False


def sh_gmg(mesh, pt, dims):
    """(solver, rho, b planes, lengths) of the bench configuration (p=0,
    rho=1, Chebyshev-node nu=2, bf16 smoother copy, flexible PCG)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar
    from pyfem_gpu_testflight_tpu_torch.parallel import (
        ShardedGMG2D, ShardedGMG3D,
    )

    conn, X, fixed, force, L = problem(*dims)
    et = "quad4" if len(dims) == 2 else "hex8"
    m = pt.LinearElasticity(et, X, conn, fixed, None, force, p=0.0,
                            dtype=torch.float32, device=mesh.device)
    cls = ShardedGMG2D if len(dims) == 2 else ShardedGMG3D
    sg = cls(mesh, *dims, *L, "elasticity", p=0.0, dtype=torch.float32,
             nu_pre=2, nu_post=2, min_n=5 if len(dims) == 2 else 3,
             omega="cheby", smoother_dtype=torch.bfloat16)
    rho = torch.ones(m.nnodes, dtype=torch.float32, device=mesh.device)
    b = interleave_to_planar(m.compute_rhs(), len(dims)).reshape(
        (len(dims),) + tuple(dims[::-1]))
    return sg, rho, b, L


def sh_gmg_line(dev, pt, mesh, label, dims, single_k):
    """13a: one bench-configuration sharded GMG solve on the world-1
    NCCL mesh; iterations against the single-device phase, the float64
    true residual, one kernel launch per smoothing call (2D: K2) or per
    pass (3D: K4), CUDA-event time, collectives per PCG iteration, peak
    memory."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    sg, rho, b, L = sh_gmg(mesh, pt, dims)
    solve = lambda: sg.solve(rho, b, rtol=1e-6, maxiter=200)
    t0 = time.time()
    solve()
    torch.cuda.synchronize()
    cold = time.time() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _cuda.reset_launches()
    e0.record()
    x, k, rn = solve()
    e1.record()
    e1.synchronize()
    ms = e0.elapsed_time(e1)
    counts = sh_counts()
    mem = torch.cuda.max_memory_allocated() - base
    coll = sg.last_stats["collectives_solve"]
    per_it = {c_: n / max(k, 1) for c_, n in coll.items()}
    mask0 = sg.asm.static_levels[0].mask
    bz = torch.where(mask0, 0.0, b)
    log(f"{label}: {int(np.prod(dims)) * len(dims)} dof, levels "
        f"{sg.asm.sizes}, {sg.S} sharded (local slabs {sg.nl}, padded from "
        f"{sg.shapes[0][0]}), halo {sg.h}; {k} PCG iterations (single "
        f"device: {single_k}), ||r||/||b|| "
        f"{float(rn) / float(torch.linalg.norm(bz)):.3e}; solve {ms:.3f} ms "
        f"(CUDA events; cold {1e3 * cold:.1f} ms host clock), peak "
        f"{mem / 2**20:.1f} MiB above {base / 2**20:.1f}; collectives per "
        f"PCG iteration {per_it} ({mesh.backend}, {mesh.transport} "
        f"transport); launches {counts}")
    check(abs(k - single_k) <= 1, f"{label}: {k} iterations, within 1 of "
          f"the single-device phase's {single_k}")
    check(float(rn) <= 1e-6 * float(torch.linalg.norm(bz)),
          f"{label}: PCG residual <= rtol")
    if len(dims) == 2:
        mv64, mvabs, _ = f64_operator(*dims, *L, rho, 0.0, dev)
        calls, nk = k2_per_call(solve)
        check(counts["K2"] > 0 and calls > 0 and nk == calls,
              f"{label}: K2 launched, one launch per smoothing call "
              f"({calls} calls, {nk} launches)")
    else:
        mv64, mvabs, _ = f64_operator_3d(dims[0], L, rho, 0.0, dev)
        calls, nk = k4_per_pass(solve)
        check(counts["pyfem_sweep_3d"] > 0 and calls > 0 and nk == calls,
              f"{label}: K4 launched, one launch per pass ({calls} "
              f"passes, {nk} launches)")
    true, floor = residuals(mv64, mvabs, bz, x)
    log(f"{label}: float64 true residual {true:.3e} (float32 floor "
        f"{floor:.3e}, ratio {true / floor:.2f})")
    check(true <= FLOOR_FACTOR * floor,
          f"{label}: true residual <= {FLOOR_FACTOR:g} x float32 floor")
    return dict(k=k, ms=ms, mem=mem, per_it=per_it, counts=counts,
                true=true, floor=floor, x=x.cpu(), calls=calls, cold=cold)


def sh_model_line(dev, pt, mesh):
    """13a: ``attach_sharded_grid(...).solve(method="sharded_gmg")`` and
    ``compliance(solver="sharded_gmg")`` at 1025x513, p=3, rho ~ U[0.3,
    1] (seed 1), float32, against the same model's single-device gmg."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float32, device=dev)
    opts = dict(nu_pre=2, nu_post=2, min_n=5, omega="cheby",
                smoother_dtype=torch.bfloat16)
    m.attach_sharded_grid(mesh, NX, NY, **opts)
    m.attach_structured_grid(NX, NY, **opts)
    rho = torch.as_tensor(np.random.default_rng(1).uniform(
        0.3, 1.0, m.nnodes), dtype=torch.float32, device=dev)
    m.solve(method="sharded_gmg", rho=rho, rtol=1e-6)  # warm
    _cuda.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    u = m.solve(method="sharded_gmg", rho=rho, rtol=1e-6)
    e1.record()
    e1.synchronize()
    counts = sh_counts()
    st = dict(m.last_solve_stats)
    u1 = m.solve(method="gmg", rho=rho, rtol=1e-6)
    k1 = m.last_solve_stats["iters"]
    c_s, _ = m.compliance(rho, solver="sharded_gmg")
    c_1, _ = m.compliance(rho, solver="gmg")
    du = float(torch.linalg.norm(u - u1) / torch.linalg.norm(u1))
    dc = abs(float(c_s) - float(c_1)) / abs(float(c_1))
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho, 3.0, dev)
    from pyfem_gpu_testflight_tpu_torch.ops.dia import interleave_to_planar

    b = torch.where(m._sgmg.asm.static_levels[0].mask, 0.0,
                    interleave_to_planar(m.compute_rhs(), 2).reshape(
                        2, NY, NX))
    true, floor = residuals(mv64, mvabs, b,
                            interleave_to_planar(u, 2).reshape(2, NY, NX))
    log(f"13a model: solve(method='sharded_gmg') {st['iters']} iterations "
        f"(gmg: {k1}), {e0.elapsed_time(e1):.3f} ms (CUDA events), "
        f"collectives {st['collectives']}; against gmg: u rel L2 "
        f"{du:.3e}, compliance {float(c_s):.6e} vs {float(c_1):.6e} (rel "
        f"{dc:.3e}); float64 true residual {true:.3e} (floor {floor:.3e}); "
        f"launches {counts}")
    check(abs(st["iters"] - k1) <= 1, "13a model: sharded_gmg iterations "
          "within 1 of gmg's")
    check(counts["K2"] > 0, "13a model: K2 launched")
    check(true <= FLOOR_FACTOR * floor, f"13a model: true residual <= "
          f"{FLOOR_FACTOR:g} x float32 floor")
    check(bool(torch.isfinite(c_s)), "13a model: compliance finite")
    return dict(k=st["iters"], k1=k1, du=du, dc=dc, true=true, floor=floor,
                counts=counts, ms=e0.elapsed_time(e1))


def sh_amg_line(dev, mesh, arm_sys, single_k):
    """13a: ``ShardedAMGPCG`` on phase 11's arm (float64, rtol 1e-10)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.parallel import ShardedAMGPCG

    K, b, X = arm_sys
    t0 = time.time()
    solver = ShardedAMGPCG(mesh, K, nd=2, coords=X, dtype=torch.float64)
    torch.cuda.synchronize()
    setup = time.time() - t0
    solver.solve(b, rtol=1e-10)  # warm
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_counts()
    _cuda.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    x, k, rn = solver.solve(b, rtol=1e-10)
    e1.record()
    e1.synchronize()
    k = int(k)
    counts = sh_counts()
    mem = torch.cuda.max_memory_allocated() - base
    res = true_residual(K, b, x)
    per_it = {c_: n / max(k, 1) for c_, n in mesh.counts.items()}
    levels = [(p["n"], p["bw"], p["sharded"]) for p in solver.plan]
    log(f"13a arm: ShardedAMGPCG set-up {setup:.2f} s (host), levels (n, "
        f"bandwidth, sharded) {levels}; {k} iterations (phase 11: "
        f"{single_k}), solve {e0.elapsed_time(e1):.3f} ms (CUDA events), "
        f"true residual {res:.3e}, peak {mem / 2**20:.1f} MiB, collectives "
        f"per iteration {per_it}, U1 launches "
        f"{counts['pyfem_csr_spmv']}")
    check(abs(k - single_k) <= 1, f"13a arm: {k} iterations, within 1 of "
          f"phase 11's {single_k}")
    check(res <= UNS_ARM_RES_TOL, f"13a arm: true residual <= "
          f"{UNS_ARM_RES_TOL:g}")
    check(counts["pyfem_csr_spmv"] > 0 and sum(p[2] for p in levels) >= 1,
          "13a arm: U1 launched, at least one sharded level")
    return dict(k=k, res=res, setup_s=setup, ms=e0.elapsed_time(e1),
                mem=mem, per_it=per_it, counts=counts, levels=levels,
                x=x.cpu())


def sh_topo_line(dev, pt, mesh, dims, iters, label):
    """13a: ``ShardedDeviceTopo`` (phase 7's / phase 10's options) against
    the single-device ``DeviceTopo`` on the same model and storage."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.opt import (
        DeviceTopo, ShardedDeviceTopo,
    )

    warm, timed = iters
    conn, X, fixed, force, _ = problem(*dims)
    et = "quad4" if len(dims) == 2 else "hex8"
    m = pt.LinearElasticity(et, X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float32, device=dev)
    opts = dict(nu_pre=2, nu_post=2, min_n=5 if len(dims) == 2 else 3,
                omega="cheby", smoother_dtype=torch.bfloat16)
    m.attach_sharded_grid(mesh, *dims, **opts)
    m.attach_structured_grid(*dims, **opts, **({} if len(dims) == 2
                                               else {"sym": False}))
    f = pt.Helmholtz(0.01, et, X, conn, dtype=torch.float32, rtol=1e-6,
                     device=dev).attach_structured_grid(*dims)
    kw = dict(fixed_volume=0.4, rtol=1e-6, maxiter=200)
    ShardedDeviceTopo(m, f, **kw).optimize(max_iterations=warm,
                                           verbose=False, log_every=warm)
    sd = ShardedDeviceTopo(m, f, **kw)
    _cuda.reset_launches()
    t0 = time.time()
    xs, _ = sd.optimize(max_iterations=timed, verbose=False,
                        log_every=timed)
    counts = sh_counts()
    s_it = (time.time() - t0) / timed
    d1 = DeviceTopo(m, f, **kw)
    x1, _ = d1.optimize(max_iterations=timed, verbose=False,
                        log_every=timed)
    o_s = np.array([h["obj"] for h in sd.history])
    o_1 = np.array([h["obj"] for h in d1.history])
    dobj = float(np.max(np.abs(o_s - o_1) / np.abs(o_1)))
    dobj0 = float(abs(o_s[0] - o_1[0]) / abs(o_1[0]))
    cg_s = [h["cg_iters"] for h in sd.history]
    cg_1 = [h["cg_iters"] for h in d1.history]
    dx = float(torch.linalg.norm(xs - x1) / torch.linalg.norm(x1))
    dx_max = float((xs - x1).abs().max())
    log(f"13a {label}: {'x'.join(map(str, dims))}, {warm} + {timed} MMA "
        f"iterations, {s_it:.4f} s an iteration (host clock, synchronized "
        f"at the end); compliance {o_s[0]:.6e} -> {o_s[-1]:.6e} (single "
        f"device {o_1[0]:.6e} -> {o_1[-1]:.6e}; first rel {dobj0:.3e}, max "
        f"rel {dobj:.3e}), design rel L2 {dx:.3e} (max |dx| {dx_max:.3e}); "
        f"state PCG {cg_s} (single device {cg_1}), filter "
        f"{[h['filter_iters'] for h in sd.history]}; launches {counts}")
    check(dx <= SH_TOPO_X_TOL
          and all(abs(a - b) <= 1 for a, b in zip(cg_s, cg_1)),
          f"13a {label}: iterates match the single-device DeviceTopo "
          f"(design rel L2 {dx:.2e} <= {SH_TOPO_X_TOL:g}, state PCG "
          f"iterations within 1)")
    check(dobj0 <= SH_TOPO_OBJ0_TOL, f"13a {label}: first compliance "
          f"within {SH_TOPO_OBJ0_TOL:g} of the single-device one "
          f"({dobj0:.2e})")
    k = "pyfem_stencil_2d" if len(dims) == 2 else "pyfem_sweep_3d"
    check(counts[k] > 0, f"13a {label}: the filter's kernel launched")
    out = dict(s_it=s_it, dobj=dobj, dobj0=dobj0, dx=dx, dx_max=dx_max,
               counts=counts, cg=(cg_s, cg_1),
               objs=(float(o_s[0]), float(o_s[-1])))
    if len(dims) == 2:
        gen = torch.Generator(device=mesh.device).manual_seed(SEED + 13)
        k9 = sh_k9_filter(sd, gen)
        log(f"13a {label}: K9 nd=1 f32 against plain on the sharded "
            f"filter's block: rel {k9['rel']:.2e}")
        check(k9["rel"] <= REL_TOL, f"13a {label}: K9 on the sharded "
              f"filter's block matches plain (<= {REL_TOL:g})")
        out["k9_rel"] = k9["rel"]
    return out


def sh_k9_filter(sd, gen):
    """K9 against its plain version on a ``ShardedDeviceTopo``'s filter
    product as the loop runs it (``halo_stencil_matvec`` at nd = 1: the
    rank's planes framed by a zero slab a side, a random block with the
    neighbours' halo rows): the relative error and the halo's max |.|
    below and above."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    mesh, fK = sd.mesh, sd._fK
    coeff = fK.reshape((1, 1, 3, 3) + tuple(fK.shape[-2:]))
    u = torch.where(sd._xpad, 0.0, torch.rand(
        sd._xpad.shape, generator=gen, device=mesh.device,
        dtype=fK.dtype))[None]
    ue = mesh.halo(u, 1, 1)
    got = sm.stencil_matvec_2d(coeff, ue)
    ref = sm.stencil_matvec_2d_plain(coeff, ue)
    return dict(rel=float((got - ref).abs().max() / ref.abs().max()),
                halo=[float(ue[:, 0].abs().max()),
                      float(ue[:, -1].abs().max())])


def sh_rank(rank, world, arm_sys, dims2, dims3, device):
    """13b: one of two ranks sharing the card over gloo.  The 2D and 3D
    bench sharded solves (``dims2``, ``dims3``) and the arm, the
    kernels' launch counts set to 0 just before them and read just
    after; then K2, K4 and U1 on this rank's halo-extended blocks of
    those solves, and K9 on the sharded 2D filter's block, against their
    plain versions."""
    import torch
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda, fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops import spmv
    from pyfem_gpu_testflight_tpu_torch.parallel import (
        ShardedAMGPCG, make_mesh,
    )

    mesh = make_mesh(world, device=device)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED + 13 + rank)
    out = {"device": str(mesh.device), "transport": mesh.transport,
           "backend": mesh.backend, "kernels": {}}
    gmgs = {"2d": sh_gmg(mesh, pt, dims2), "3d": sh_gmg(mesh, pt, dims3)}
    K, bb, X = arm_sys
    solver = ShardedAMGPCG(mesh, K, nd=2, coords=X, dtype=torch.float64)
    _cuda.reset_launches()
    for key, (sg, rho, b, _) in gmgs.items():
        mesh.reset_counts()
        x, k, rn = sg.solve(rho, b, rtol=1e-6, maxiter=200)
        out[key] = dict(x=x.cpu(), k=k, coll=dict(
            sg.last_stats["collectives_solve"]), nl=sg.nl)
    mesh.reset_counts()
    x, k, rn = solver.solve(bb, rtol=1e-10)
    out["arm"] = dict(x=x.cpu(), k=int(k), coll=dict(mesh.counts),
                      sharded=[p["sharded"] for p in solver.plan])
    out["launches"] = sh_counts()
    # the kernels on this rank's level-0 blocks, halos exchanged
    for key, (sg, rho, b, _) in gmgs.items():
        rho_loc = sg._local(rho.reshape(sg.shapes[0]), 0, axis=0)
        lv = sg.hierarchy(rho_loc.contiguous()).levels[0]
        v = torch.where(lv.mask, 0.0, torch.rand(
            lv.mask.shape, generator=gen, device=mesh.device))
        ve = sg._ext(v, sg.h)
        halo = [float(ve.narrow(1, 0, sg.h).abs().max()),
                float(ve.narrow(1, ve.shape[1] - sg.h, sg.h).abs().max())]
        bk = sg._ext(torch.where(lv.mask, 0.0, torch.rand(
            lv.mask.shape, generator=gen, device=mesh.device)), sg.h)
        oms = sg._omegas(2)
        if key == "2d":
            forms = {
                "K2 presmooth_resid bf16": (
                    lambda f: f(lv.ck_s, lv.dk, bk, None, niter=2,
                                want_resid=True, omega=oms),
                    fs.fused_sweeps_2d, fs.fused_sweeps_2d_plain),
                "K2 postsmooth bf16": (
                    lambda f: f(lv.ck_s, lv.dk, bk, ve, niter=2,
                                omega=oms),
                    fs.fused_sweeps_2d, fs.fused_sweeps_2d_plain),
                "K2 postsmooth_resid f32": (
                    lambda f: f(lv.ck, lv.dk, bk, ve, niter=2,
                                want_resid=True, omega=oms),
                    fs.fused_sweeps_2d, fs.fused_sweeps_2d_plain),
                "K2 matvec f32": (
                    lambda f: f(lv.ck, lv.dk, None, ve, niter=0,
                                want_resid=True, neg_resid=True),
                    fs.fused_sweeps_2d, fs.fused_sweeps_2d_plain),
            }
        else:
            forms = {
                "K4 sweep bf16": (
                    lambda f: f(lv.ck_s, lv.dk, bk, ve, mode="sweep",
                                omega=oms[0]),
                    fs.fused_sweep_3d, fs.fused_sweep_3d_plain),
                "K4 matvec f32": (
                    lambda f: f(lv.ck, x=ve, mode="matvec", neg_resid=True),
                    fs.fused_sweep_3d, fs.fused_sweep_3d_plain),
            }
        for name, (call, kern, plain) in forms.items():
            got, ref = call(kern), call(plain)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max(float((g - r).abs().max() / r.abs().max())
                      for g, r in zip(got, ref))
            out["kernels"][name] = dict(rel=err, halo=halo)
    del gmgs
    out["kernels"]["K9 filter nd=1 f32"] = sh_k9_filter(
        sh_filter_topo(mesh, pt, dims2), gen)
    A = solver._loc[0]["op"]
    u = torch.rand(A.nl, generator=gen, device=mesh.device,
                   dtype=torch.float64)
    uh = mesh.halo(u, 0, A.bw)
    halo = [float(uh[: A.bw].abs().max()), float(uh[-A.bw:].abs().max())]
    got = spmv.csr_matvec(A.indptr, A.indices, A.vals, uh)
    ref = spmv.csr_matvec_plain(A.indptr, A.indices, A.vals, uh)
    out["kernels"]["U1 arm fine block f64"] = dict(
        rel=float((got - ref).abs().max() / ref.abs().max()), halo=halo)
    return out


def sh_filter_topo(mesh, pt, dims):
    """A ``ShardedDeviceTopo`` of 13a's 2D topology options on ``mesh``
    (its filter planes are made on construction; no iteration runs)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.opt import ShardedDeviceTopo

    conn, X, fixed, force, _ = problem(*dims)
    m = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=3.0,
                            dtype=torch.float32, device=mesh.device)
    m.attach_sharded_grid(mesh, *dims, nu_pre=2, nu_post=2, min_n=5,
                          omega="cheby", smoother_dtype=torch.bfloat16)
    f = pt.Helmholtz(0.01, "quad4", X, conn, dtype=torch.float32,
                     rtol=1e-6, device=mesh.device).attach_structured_grid(
                         *dims)
    return ShardedDeviceTopo(m, f, fixed_volume=0.4, rtol=1e-6, maxiter=200)


def phase_sharded(dev, pt, single, arm_sys):
    """Phase 13: the multi-rank solvers (``parallel``) on the card.

    13a, world 1 on NCCL, in this process: the 2D and 3D bench
    configurations through ``ShardedGMG2D`` / ``ShardedGMG3D`` (one K2
    launch per 2D smoothing call on an h-row halo block, K4 passes in
    3D), the model entry (``attach_sharded_grid``, ``solve(method=
    "sharded_gmg")``, ``compliance``) at 1025x513 p=3, ``ShardedAMGPCG`` on
    phase 11's arm and ``ShardedDeviceTopo`` in 2D (1025x513) and 3D
    (65x33x33).  13b: two spawned ranks on the one card over gloo (host
    transport), the 2D, 3D and arm solves against 13a's, and K2, K4, K9
    and U1 on each rank's halo-extended blocks against their plain
    versions.  13c: ``parallel.dryrun_multichip(2)`` on the card."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.parallel import (
        dryrun_multichip, make_mesh, run_ranks,
    )

    out = {}
    t0 = time.time()
    with world1_nccl():
        mesh = make_mesh(1, device=SH_DEVICE)
        log(f"13a: world 1, backend {mesh.backend}, transport "
            f"{mesh.transport}, {mesh.device}")
        out["2d"] = sh_gmg_line(dev, pt, mesh, "13a bench 2D", (NX, NY),
                                single["k2d"])
        out["3d"] = sh_gmg_line(dev, pt, mesh, "13a bench 3D", (N3,) * 3,
                                single["k3d"])
        out["model"] = sh_model_line(dev, pt, mesh)
        out["arm"] = sh_amg_line(dev, mesh, arm_sys, single["k_arm"])
        out["topo"] = sh_topo_line(dev, pt, mesh, (NX, NY), SH_TOPO,
                                   "topo")
        n = SH_TOPO3D_N
        out["topo3d"] = sh_topo_line(dev, pt, mesh, (2 * n - 1, n, n),
                                     SH_TOPO3D, "topo3d")
    out["s_13a"] = time.time() - t0

    t0 = time.time()
    try:
        ranks = run_ranks(sh_rank, 2, args=(arm_sys, (NX, NY), (N3,) * 3,
                                            SH_DEVICE),
                          timeout=SH_TIMEOUT)
    except RuntimeError as e:
        check(False, f"13b: two gloo ranks on the card: {e}")
        ranks = None
    out["s_13b"] = time.time() - t0
    if ranks is not None:
        out["13b"] = sh_compare(out, ranks)
    t0 = time.time()
    try:
        res = dryrun_multichip(2, device=SH_DEVICE, timeout=SH_TIMEOUT,
                               verbose=False)
        for line in __import__(
                "pyfem_gpu_testflight_tpu_torch.parallel.dryrun",
                fromlist=["summary_lines"]).summary_lines(res):
            log("13c " + line)
        check(res["device"].startswith("cuda"),
              f"13c: dryrun_multichip(2) on the card ({res['device']})")
        out["13c"] = {k: v for k, v in res.items() if np.isscalar(v)}
    except RuntimeError as e:
        check(False, f"13c: dryrun_multichip(2): {e}")
    out["s_13c"] = time.time() - t0
    log(f"phase 13: 13a {out['s_13a']:.1f} s, 13b {out['s_13b']:.1f} s, "
        f"13c {out['s_13c']:.1f} s")
    return out


def sh_compare(out, ranks):
    """13b's readings against 13a's world-1 solutions."""
    import torch

    res = {"kernels": {}, "launches": [r["launches"] for r in ranks]}
    for r, o in enumerate(ranks):
        log(f"13b rank {r}: {o['device']}, {o['backend']} ({o['transport']} "
            f"transport); the solves' launches {o['launches']}")
        check(all(o["launches"][e] > 0 for e in SH_13B_PATH),
              f"13b rank {r}: K2, K4 and U1 launched in the solves")
        for name, kv in o["kernels"].items():
            res["kernels"][f"rank{r} {name}"] = kv
            log(f"13b rank {r}: {name} against plain on the halo-extended "
                f"block: rel {kv['rel']:.2e} (halo max |.| below/above "
                f"{kv['halo'][0]:.2e}/{kv['halo'][1]:.2e})")
            inner = kv["halo"][1] if r == 0 else kv["halo"][0]
            check(kv["rel"] <= REL_TOL and inner > 0,
                  f"13b rank {r}: {name} matches plain (<= {REL_TOL:g}) on a "
                  f"block whose inner halo is not zero")
    for key in ("2d", "3d", "arm"):
        ks = [o[key]["k"] for o in ranks]
        x0 = out[key]["x"].double()
        rels = [float(torch.linalg.norm(o[key]["x"].double() - x0)
                      / torch.linalg.norm(x0)) for o in ranks]
        res[key] = dict(k=ks, rel=rels, coll=[o[key]["coll"] for o in ranks])
        log(f"13b {key}: iterations {ks} (world 1: {out[key]['k']}), "
            f"solution rel L2 against world 1 {rels}, collectives "
            f"{res[key]['coll'][0]}" + (f", sharded levels "
                                        f"{ranks[0]['arm']['sharded']}"
                                        if key == "arm" else ""))
        check(all(abs(k - out[key]["k"]) <= 1 for k in ks)
              and max(rels) <= SH_W2_REL[key],
              f"13b {key}: two ranks within 1 iteration of world 1 and "
              f"within {SH_W2_REL[key]:g} (rel L2)")
    check(sum(ranks[0]["arm"]["sharded"]) >= 1,
          "13b arm: at least one sharded level")
    return res


def arm_system(dev, pt):
    """Phase 11's arm as (K, b, coordinates) for ``--sharded``."""
    from pyfem_gpu_testflight_tpu_torch.examples import torque_arm

    nr, nt = UNS_ARM
    inp = str(uns_dir() / f"arm_{nr}x{nt}.inp")
    torque_arm.synthesize_arm_inp(inp, nr=nr, nt=nt)
    model = torque_arm.arm_model(inp, device=dev)[0]
    K, b = model.bc.apply_scipy(
        model.assemble_scipy(model.element_jacobian(1.0)),
        model.compute_rhs().cpu().numpy())
    return model, (K, b, model.X_host)


# the kernels 13b's solves run (K9 runs in the sharded filter, 13a only)
SH_13B_PATH = ("K2", "pyfem_sweep_3d", "pyfem_csr_spmv")


def sharded_row(sh, entry, key):
    """Phase 13's launches of one kernel entry point (13a's lines, 13b's
    ranks' solves) and the largest 13b relative error of its forms (K9:
    also 13a's, on the topology loop's filter block)."""
    lines = ("2d", "3d", "model", "arm", "topo", "topo3d")
    out = {"launches_sharded": {f"13a_{k}": sh[k]["counts"].get(entry, 0)
                                for k in lines if k in sh}}
    if "k9_rel" in sh.get("topo", {}) and key == "K9":
        out["sharded_13a_rel"] = sh["topo"]["k9_rel"]
    if "13b" in sh and entry in SH_13B_PATH:
        for r, c in enumerate(sh["13b"]["launches"]):
            out["launches_sharded"][f"13b_rank{r}"] = c.get(entry, 0)
    if "13b" in sh:
        errs = [v["rel"] for k, v in sh["13b"]["kernels"].items()
                if k.split()[1] == key]
        if errs:
            out["sharded_13b_rel"] = max(errs)
    return out


def sharded_summary(sh):
    """Phase 13's figures as one JSON-able dict."""
    pick = lambda d, ks: {k: d[k] for k in ks if k in d}
    out = {k: pick(sh[k], ("k", "ms", "mem", "per_it", "true", "floor",
                           "res", "setup_s", "levels", "du", "dc", "k1",
                           "s_it", "dobj", "dobj0", "dx", "dx_max", "cg",
                           "objs"))
           for k in ("2d", "3d", "model", "arm", "topo", "topo3d")}
    if "13b" in sh:
        out["13b"] = {k: sh["13b"][k] for k in ("2d", "3d", "arm")}
    out["13c"] = sh.get("13c")
    out["seconds"] = {k: sh[k] for k in ("s_13a", "s_13b", "s_13c")}
    return out


def run_sharded():
    """``python3 chip_smoke.py --sharded``: only phase 13 (with the kernel
    build); its single-device yardsticks are run here (bench 2D and 3D
    solves, the arm's AMG-PCG)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )

    log(card_line())
    dev = torch.device("cuda", 0)
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    _, _, rho, rhs, step, _ = bench2d(dev, pt, multigrid, i2p, p2i)
    k2d = step(rho, rhs, rhs)[1]
    k3d = bench3d_iters(dev, pt, multigrid, i2p)
    model, arm_sys = arm_system(dev, pt)
    model.solve(method="amg", rtol=1e-10)
    single = dict(k2d=k2d, k3d=k3d, k_arm=model.last_solve_stats["iters"])
    del model
    log(f"single-device yardsticks: {single}")
    sh = phase_sharded(dev, pt, single, arm_sys)
    log(json.dumps({"sharded": sharded_summary(sh)}))
    log(card_line())
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    return 0


# -- phase 14: GMG solves with nonzero Dirichlet values ----------------------

DIR_SEED = 14
DIR_ROUTES_2D = ({}, {"sym": True}, {"elem_path": "cuda"})
DIR_ROUTES_3D = ({}, {"sym": False}, {"elem_path": "otf"})
# entry points of every kernel a lifted solve may launch, by kernels-line row
DIR_ENTRY = {
    "K1": ("pyfem_assemble_2d",), "K1-sym": ("pyfem_assemble_2d_sym",),
    "K2": K2_ENTRIES, "K2-sym": K2_SYM_ENTRIES,
    "K3": ("pyfem_assemble_3d",), "K4": ("pyfem_sweep_3d",),
    "K5": ("pyfem_sweeps_3d",), "K6": ("pyfem_otf_3d",),
    "K6-tc": ("pyfem_otf_3d_tc",), "K7a": ("pyfem_elasticity_quad4",),
    "K7b": ("pyfem_poisson_quad4",), "K8": ("pyfem_stiffness_3d",),
    "K9": ("pyfem_stencil_2d",),
}
DIR_NAMES = tuple(sorted({e for v in DIR_ENTRY.values() for e in v}))
# the kernels each lifted solve must launch, by dimension and route (K7:
# K7a for elasticity, K7b for Poisson), and its lift's product kernel
DIR_WANT = {
    (2, "uniform"): ("K1", "K2", "K9"), (2, "sym"): ("K1-sym", "K2-sym", "K9"),
    (2, "elem_path=cuda"): ("K7", "K2", "K9"),
    (3, "uniform"): ("K3", "K4", "K5"), (3, "sym=False"): ("K3", "K4", "K5"),
    (3, "elem_path=otf"): ("K3", "K6", "K6-tc"),
}
DIR_LIFT = {2: "K9", 3: "K4", "otf": "K6"}


def dir_route(route):
    """A route's name in labels: uniform, sym, sym=False, elem_path=..."""
    if not route:
        return "uniform"
    return " ".join("sym" if (k, v) == ("sym", True) else f"{k}={v}"
                    for k, v in route.items())
# 14d: the oracle gates' projection tolerance (tests/test_hex8_oracle.py,
# test_elasticity.py, test_quadratic_oracles.py)
ORACLE_TOL = 1e-10


def dir_counts():
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    return {k: _cuda.launches.get(k, 0) for k in DIR_NAMES}


def dir_model(pt, dev, physics, dims):
    """A 14a/14b model (float32) with its Dirichlet values: Poisson (g = 1,
    rho = 1) with the x = 0 edge / face held at T = 0.3 + 0.7 y / Ly;
    elasticity with ux = 1e-3 (y / Ly - 0.5), uy (uz) = 0 there, at p = 3
    and rho ~ U[0.3, 1] (seed 14) in 2D, bench 3D's p = 0, rho = 1 in 3D.
    Returns (model, rho, fixed, vals)."""
    import torch

    dim = len(dims)
    c = pt.ProblemCreator(*dims, element_type="quad" if dim == 2
                          else "block")
    etype = "quad4" if dim == 2 else "hex8"
    f32 = torch.float32
    if physics == "poisson":
        conn, X, fixed = c.create_poisson_problem()
        Ly = float(X[:, 1].max())
        vals = 0.3 + 0.7 * X[fixed, 1] / Ly
        m = pt.LinearPoisson(etype, X, conn, fixed, vals,
                             gfunc=lambda x: torch.ones_like(x[..., 0]),
                             dtype=f32, device=dev)
        rho = np.ones(len(X))
    else:
        conn, X, fixed, force = c.create_linear_elasticity_problem()
        Ly = float(X[:, 1].max())
        node, comp = fixed // dim, fixed % dim
        vals = np.where(comp == 0, 1e-3 * (X[node, 1] / Ly - 0.5), 0.0)
        p = 3.0 if dim == 2 else 0.0
        m = pt.LinearElasticity(etype, X, conn, fixed, vals, force, p=p,
                                dtype=f32, device=dev)
        rho = (np.random.default_rng(DIR_SEED).uniform(0.3, 1.0, len(X))
               if dim == 2 else np.ones(len(X)))
    return m, torch.as_tensor(rho, dtype=f32, device=dev), fixed, vals


def dir_f64(m, dims, rho):
    """The float64 yardsticks of a 14a/14b model, by the plain path: the
    eliminated operator A (and |A|) and the un-eliminated product of the
    lift, from ``assemble_pack_*_plain`` with the model's mask and with
    every dof free, applied by ``Stencil{2,3}D.matvec``."""
    import torch
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

    dim, nd = len(dims), m.ndof_per_node
    physics = "poisson" if nd == 1 else "elasticity"
    mask = m._gmg_asm.static_levels[0].mask.cpu().numpy()
    L = [float(m.X_host[:, k].max()) for k in range(dim)]
    kw = dict(p=m.p, dtype=torch.float64, device=rho.device,
              fine_mask=mask)
    if physics == "elasticity":
        kw.update(E=m.E, nu=m.nu)
    cls = multigrid.GMGAssembler if dim == 2 else multigrid.GMGAssembler3D
    a = cls(*dims, *L, physics, **kw)
    st = a.static_levels[0]
    plain = (fa.assemble_pack_2d_plain if dim == 2
             else fa.assemble_pack_3d_plain)
    full = fs.as_full_planes_2d if dim == 2 else fs.as_full_planes_3d
    r64 = rho.double().reshape(st.shape)
    planes = [full(plain(r64, mf, st.W, a.N, nd=nd, p=m.p, sym=False)[0],
                   nd) for mf in (st.maskf, torch.ones_like(st.maskf))]
    ce, raw = planes
    ca = ce.abs()
    return dict(mv=lambda u: st.op.matvec(ce, u),
                mvabs=lambda u: st.op.matvec(ca, u),
                lift=lambda v: st.op.matvec(raw, v), raw=raw, mask=st.mask)


def dir_line(dev, pt, multigrid, i2p, p2i, label, physics, dims, route,
             f64=None):
    """One 14a/14b line: the lifted solve through ``solve(method="gmg")``
    with bench 2D's / 3D's options (Chebyshev-node nu=2, bf16 smoother
    copy, flexible PCG, rtol 1e-6) on ``route``, its launches, the four
    checks (fixed entries exact, b against the float64 plain lift, the
    float64 true residual against 4x its float32 floor, iterations within
    2 of the zero-value solve) and, in 3D, the solution against the
    float64-outer solve.  ``f64``: the physics' float64 yardsticks when
    an earlier route built them (same problem and density)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    m, rho, fixed, vals = dir_model(pt, dev, physics, dims)
    nd, shape = m.ndof_per_node, tuple(dims[::-1])
    m.attach_structured_grid(*dims, omega="cheby",
                             smoother_dtype=torch.bfloat16, **route)
    asm = m._gmg_asm
    rhs = m.compute_rhs()
    m.solve(method="gmg", rho=rho, rtol=1e-6)  # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _cuda.reset_launches()
    e0.record()
    u = m.solve(method="gmg", rho=rho, rtol=1e-6)
    e1.record()
    e1.synchronize()
    counts = dir_counts()
    solve_ms = e0.elapsed_time(e1)
    k = m.last_solve_stats["iters"]
    u2, b = m._solve_system(None, rhs, "gmg", rtol=1e-6, rho=rho)
    check(torch.equal(u2, u), f"{label}: the solve is repeatable bit for "
          f"bit")
    # the zero-value solve of the same model: the same hierarchy and PCG
    gmg, lv0 = asm.assemble(rho)
    b0 = torch.where(lv0.mask, 0.0, i2p(rhs, nd).reshape((nd,) + shape))
    _x, k0, _ = multigrid.pcg_gmg(gmg, lv0, b0, rtol=1e-6, maxiter=400,
                                  flexible=True)
    # the lift alone: its time and launches
    vals_t = torch.zeros(m.ndof, dtype=torch.float32, device=dev)
    vals_t[torch.as_tensor(fixed, device=dev)] = torch.as_tensor(
        vals, dtype=torch.float32, device=dev)
    vz = i2p(vals_t, nd).reshape((nd,) + shape)
    run = lambda: asm._dirichlet_lift(rho, vz)
    lift_ms = cuda_ms(run, 10)
    _cuda.reset_launches()
    run()
    torch.cuda.synchronize()
    lift_counts = {k_: v for k_, v in dir_counts().items() if v}
    # checks
    name = dir_route(route)
    want = [("K7a" if nd > 1 else "K7b") if k_ == "K7" else k_
            for k_ in DIR_WANT[len(dims), name]]
    ran = {k_: sum(counts[e] for e in DIR_ENTRY[k_]) for k_ in want}
    check(all(ran.values()), f"{label}: {', '.join(want)} launched in the "
          f"solve ({ran})")
    lk = DIR_LIFT["otf" if name == "elem_path=otf" else len(dims)]
    check(all(lift_counts.get(e, 0) >= 1 for e in DIR_ENTRY[lk]),
          f"{label}: the lift's product runs on {lk} ({lift_counts})")
    fixed_t = torch.as_tensor(fixed, device=dev)
    check(torch.equal(u[fixed_t], vals_t[fixed_t]),
          f"{label}: the fixed entries equal the values exactly")
    f64 = f64 or dir_f64(m, dims, rho)
    v64 = vz.double()
    rhs64 = i2p(rhs.double(), nd).reshape((nd,) + shape)
    b64 = torch.where(f64["mask"], v64, rhs64 - f64["lift"](v64))
    bg = i2p(b, nd).reshape((nd,) + shape)
    db = float((bg.double() - b64).abs().max() / b64.abs().max())
    check(db <= REL_TOL, f"{label}: lifted b within {REL_TOL:g} of max|b| "
          f"of the float64 plain lift ({db:.2e})")
    x = i2p(u, nd).reshape((nd,) + shape)
    true, floor = residuals(f64["mv"], f64["mvabs"], b64, x)
    check(true <= FLOOR_FACTOR * floor,
          f"{label}: float64 true residual {true:.3e} <= {FLOOR_FACTOR:g} x "
          f"its float32 floor {floor:.3e}")
    check(k <= k0 + 2, f"{label}: {k} PCG iterations, <= 2 above the "
          f"zero-value solve's {k0}")
    out = dict(k=k, k0=k0, solve_ms=solve_ms, lift_ms=lift_ms, db=db,
               true=true, floor=floor, counts=counts,
               lift_counts=lift_counts, vz=vz, rho=rho, model=m)
    if len(dims) == 3:
        # the float64-outer solve of the lifted system, on the correction
        # from v (b at free dofs, 0 at fixed ones), as the model solves
        ya, ka, _ = accuracy_solve(gmg, f64["mv"],
                                   torch.where(f64["mask"], 0.0, b64))
        xa = v64 + ya
        err = float((x.double() - xa).abs().max() / xa.abs().max())
        check(err <= SOL64_TOL, f"{label}: solution within {SOL64_TOL:g} of "
              f"the float64-outer solve ({err:.3e}, {ka} outer iterations)")
        out["err64"] = err
    log(f"{label}: {k} PCG iterations (zero values: {k0}), solve "
        f"{solve_ms:.3f} ms, the lift alone {lift_ms:.3f} ms "
        f"({lift_counts}), launches {counts}; b vs float64 lift {db:.2e}, "
        f"true residual {true:.3e} (floor {floor:.3e}, ratio "
        f"{true / floor:.2f})"
        + (f", solution vs float64-outer {out['err64']:.3e}"
           if "err64" in out else ""))
    return out, f64


def dir_kernel_form(name, run, plain, bound_args, lib=None):
    """A lift kernel against its plain version on the line's inputs: the
    relative error (<= REL_TOL), CUDA-event times of both, the bound and
    the one-call library time (``lib``, where there is one)."""
    import torch

    got, ref = run(), plain()
    torch.cuda.synchronize()
    ea, er = rel_err(got, ref)
    check(er <= REL_TOL, f"{name}: within {REL_TOL:g} of plain (rel "
          f"{er:.2e})")
    b_ms, b_by = bound(*bound_args)
    r = dict(max_abs_err=ea, rel=er, ms=cuda_ms(run, 20),
             plain_ms=cuda_ms(plain, 5), bound_ms=b_ms, bound_by=b_by,
             library_ms=None if lib is None else lib())
    log(f"{name}: rel {er:.2e}, kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
        f"{fms(r['library_ms'])} ms")
    return r


def dir_lift_forms(line, f64, dims):
    """14a/14b: the lift's kernels against their plain versions on a
    line's un-eliminated planes and values: K9 (2D, float32 on the K1
    all-free planes and float64 on the plain float64 ones), K4 (3D,
    matvec mode, float32, full storage) or K6 (the OTF route, float32
    body with an all-free mask)."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import fused_assemble as fa
    from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs
    from pyfem_gpu_testflight_tpu_torch.ops import otf3d
    from pyfem_gpu_testflight_tpu_torch.ops import stencil_matvec as sm

    m, rho, vz = line["model"], line["rho"], line["vz"]
    asm, nd = m._gmg_asm, m.ndof_per_node
    st = asm.static_levels[0]
    shape = tuple(dims[::-1])
    n = int(np.prod(shape))
    free = torch.ones_like(st.maskf)
    forms = {}
    if st.otf is not None:
        w3, wd = st.otf
        rg = rho.reshape(shape).contiguous()
        kw = dict(niter=0, want_resid=True, neg_resid=True, p=asm.p)
        forms[f"K6 nd={nd} f32"] = dir_kernel_form(
            f"K6 lift nd={nd} {'x'.join(map(str, dims))}",
            lambda: otf3d.otf_apply_3d(rg, free, w3, wd, None, vz, **kw),
            lambda: otf3d.otf_apply_3d_plain(rg, free, w3, wd, None, vz,
                                             **kw),
            (nbytes(rg, free, w3, wd, vz) + nbytes(vz),
             2 * (nd * nd * (512 + 27) + 64) * n))
        return forms
    if len(dims) == 2:
        c32 = fa.assemble_pack_2d(rho.reshape(shape).contiguous(), free,
                                  st.W, asm.N, nd=nd, p=asm.p)[0]
        for dt, c in ((torch.float32, c32.reshape((nd, nd, 3, 3) + shape)),
                      (torch.float64, f64["raw"].contiguous())):
            v = vz.to(dt)
            flop_s = F32_FLOP_S if dt == torch.float32 else F64_FLOP_S
            forms[f"K9 nd={nd} {str(dt)[6:]}"] = dir_kernel_form(
                f"K9 lift nd={nd} {str(dt)[6:]} {NX}x{NY}",
                lambda c=c, v=v: sm.stencil_matvec_2d(c, v),
                lambda c=c, v=v: sm.stencil_matvec_2d_plain(c, v),
                (nbytes(c, v) + nbytes(v), 2 * nd * nd * 9 * n, flop_s),
                lambda c=c, v=v, dt=dt: library_matvec_ms(c, shape, v, dt))
        return forms
    c = fa.assemble_pack_3d(rho.reshape(shape).contiguous(), free, st.W,
                            asm.N, nd=nd, p=asm.p, sym=False)[0]
    kw = dict(x=vz, mode="matvec", neg_resid=True)
    forms[f"K4 nd={nd} f32 full"] = dir_kernel_form(
        f"K4 lift nd={nd} f32 full storage {'x'.join(map(str, dims))}",
        lambda: fs.fused_sweep_3d(c, **kw),
        lambda: fs.fused_sweep_3d_plain(c, **kw),
        (nbytes(c, vz) + nbytes(vz), 2 * nd * nd * 27 * n),
        lambda: library_matvec_ms(fs.as_full_planes_3d(c, nd), shape, vz))
    return forms


def dir_nu8(dev, pt, multigrid, i2p, p2i):
    """14c: bench 2D (p = 0, rho = 1, Chebyshev-node factors, bf16
    smoother copy, flexible PCG, rtol 1e-6) with nu_pre = nu_post = 8,
    beyond K2's budget of 4 stencil steps a launch (JAX
    ``tests/test_multigrid.py:285`` at the bench width): converged below
    maxiter, K2 launches per smoothing call, and the float64 true
    residual against ``f64_operator`` (K1's plain version in float64, an
    operator assembled apart from the float32 kernels) at most 4x its
    float32 floor."""
    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    conn, X, fixed, force, (Lx, Ly) = problem(NX, NY)
    model = pt.LinearElasticity("quad4", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler(
        NX, NY, Lx, Ly, "elasticity", p=0.0, dtype=torch.float32,
        device=dev, nu_pre=8, nu_post=8, smoother_dtype=torch.bfloat16,
        omega="cheby")
    rho = torch.ones(model.nnodes, dtype=torch.float32, device=dev)
    rhs = model.compute_rhs()

    def run():
        gmg, lv0 = asm.assemble(rho)
        b = torch.where(lv0.mask, 0.0, i2p(rhs, 2).reshape(2, NY, NX))
        return multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                                 flexible=True) + (b,)

    run()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    x, k, rn, b = run()
    e1.record()
    e1.synchronize()
    counts = dir_counts()
    calls, nk2 = k2_per_call(run)
    mv64, mvabs, _ = f64_operator(NX, NY, Lx, Ly, rho, 0.0, dev)
    true, floor = residuals(mv64, mvabs, b, x)
    log(f"14c nu=8: {k} PCG iterations, ||r||/||b|| "
        f"{float(rn) / float(torch.linalg.norm(b)):.3e}, "
        f"{e0.elapsed_time(e1):.3f} ms, {calls} smoothing calls, {nk2} K2 "
        f"launches, true residual {true:.3e} (floor {floor:.3e}, ratio "
        f"{true / floor:.2f})")
    check(k < 200 and float(rn) <= 1e-6 * float(torch.linalg.norm(b)),
          "14c nu=8: converged below maxiter")
    check(nk2 > calls, "14c nu=8: K2 takes more than one launch a call "
          "(sweep groups)")
    check(true <= FLOOR_FACTOR * floor,
          f"14c nu=8: float64 true residual <= {FLOOR_FACTOR:g} x its float32 "
          f"floor")
    return dict(k=k, true=true, floor=floor, calls=calls, k2=nk2,
                counts=counts, ms=e0.elapsed_time(e1))


def dir_oracles(dev, pt):
    """14d: the oracle gates on the card, at the JAX tests' sizes: the
    port's float64 einsum route (CUDA tensors; the host direct solve, and
    CG at rtol 1e-12 for hex8 elasticity) against ``tests/oracles/`` by
    the seed-123 projection (<= ``ORACLE_TOL``), then the
    ``kernel="cuda"`` route (K7a / K8) in float32 by Jacobi-CG at rtol
    1e-6: its float64 true residual against the float64 einsum
    operator at most 4 x max(rtol, its float32 floor) (PERF.md section
    2), its projection error printed."""
    import warnings

    import torch
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda

    sys.path.insert(0, "tests")
    from oracles.hex8_oracle import solve_elasticity_3d, solve_poisson_3d
    from oracles.plane_stress_oracle import solve_plane_stress
    from oracles.quadratic_oracle import (
        solve_poisson_brick20, solve_poisson_tet10,
    )

    def proj(u, ref):
        p = np.random.RandomState(123).rand(ref.shape[0])
        u = u.detach().cpu().double().numpy()
        return abs((p @ u - p @ ref) / (p @ ref))

    g3 = lambda x: x[..., 0] * x[..., 1] + x[..., 2]
    gq = lambda x: 1.0 + x[..., 0] + 2.0 * x[..., 1] - 0.5 * x[..., 2]
    cases = (
        ("plane stress 32x32", (32, 32), "quad", "quad4", None,
         lambda c, X, f, F: solve_plane_stress(c, X, f, F)),
        ("hex8 elasticity 8^3", (8, 8, 8), "block", "hex8", None,
         lambda c, X, f, F: solve_elasticity_3d(c, X, f, F)),
        ("hex8 poisson 8^3", (8, 8, 8), "block", "hex8", g3,
         lambda c, X, f, F: solve_poisson_3d(
             c, X, f, lambda x: x[0] * x[1] + x[2])),
        ("tet10 poisson 7^3", (7, 7, 7), "tet", "tet10", gq,
         lambda c, X, f, F: solve_poisson_tet10(c, X, f, gq)),
        ("brick20 poisson 7^3", (7, 7, 7), "brick20", "brick20", gq,
         lambda c, X, f, F: solve_poisson_brick20(c, X, f, gq)),
    )
    out = {}
    for label, dims, make, etype, g, oracle in cases:
        c = pt.ProblemCreator(*dims, element_type=make)
        if g is None:
            conn, X, fixed, force = c.create_linear_elasticity_problem()
            mk = lambda **kw: pt.LinearElasticity(etype, X, conn, fixed, None,
                                                  force, device=dev, **kw)
        else:
            conn, X, fixed = c.create_poisson_problem()
            force = None
            mk = lambda **kw: pt.LinearPoisson(etype, X, conn, fixed,
                                               gfunc=g, device=dev, **kw)
        u_ref = oracle(conn, X, fixed, force)
        m64 = mk()
        errs = [proj(m64.solve(method="direct"), u_ref)]
        if label.startswith("hex8 elasticity"):
            errs.append(proj(m64.solve(method="cg", rtol=1e-12), u_ref))
        check(max(errs) < ORACLE_TOL, f"14d {label}: float64 einsum route "
              f"against the oracle ({max(errs):.2e})")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m32 = mk(dtype=torch.float32, kernel="cuda")
        _cuda.reset_launches()
        u32 = m32.solve(method="cg", rtol=1e-6)
        torch.cuda.synchronize()
        counts = {k: v for k, v in dir_counts().items() if v}
        K, b = m64.bc.apply_scipy(m64.assemble_scipy(
            m64.element_jacobian()), m64.compute_rhs().cpu().numpy())
        u = u32.double().cpu().numpy()
        bn = np.linalg.norm(b)
        true = np.linalg.norm(b - K @ u) / bn
        floor = 2.0 ** -24 * np.linalg.norm(abs(K) @ np.abs(u)) / bn
        e32 = proj(u32, u_ref)
        log(f"14d {label}: float64 einsum {max(errs):.2e} from the oracle; "
            f"kernel='cuda' float32 CG {m32.last_solve_stats['iters']} "
            f"iterations, launches {counts}, true residual {true:.3e} "
            f"(floor {floor:.3e}), {e32:.2e} from the oracle")
        check(true <= FLOOR_FACTOR * max(1e-6, floor),
              f"14d {label}: kernel='cuda' float32 true residual <= "
              f"{FLOOR_FACTOR:g} x max(rtol, floor)")
        out[label] = dict(err64=max(errs), err32=e32, true=true,
                          floor=floor, counts=counts)
    return out


def phase_dirichlet(dev, pt, multigrid, i2p, p2i):
    """Phase 14 (see the module docstring)."""
    t0 = time.time()
    res = dict(lines={}, forms={}, launches={})
    for physics, routes in (("poisson", DIR_ROUTES_2D),
                            ("elasticity", ({},))):
        f64 = None
        for route in routes:
            label = f"14a {physics} {dir_route(route)}"
            line, f64 = dir_line(dev, pt, multigrid, i2p, p2i, label,
                                 physics, (NX, NY), route, f64)
            if not route:
                res["forms"].update(dir_lift_forms(line, f64, (NX, NY)))
            res["launches"][label] = line.pop("counts")
            res["lines"][label] = {k: v for k, v in line.items()
                                   if k not in ("vz", "rho", "model")}
        del f64
    for physics in ("poisson", "elasticity"):
        f64 = None
        for route in DIR_ROUTES_3D:
            label = f"14b {physics} {dir_route(route)}"
            line, f64 = dir_line(dev, pt, multigrid, i2p, p2i, label,
                                 physics, (N3,) * 3, route, f64)
            if not route or route.get("elem_path") == "otf":
                res["forms"].update(dir_lift_forms(line, f64, (N3,) * 3))
            res["launches"][label] = line.pop("counts")
            res["lines"][label] = {k: v for k, v in line.items()
                                   if k not in ("vz", "rho", "model")}
        del f64
    res["nu8"] = dir_nu8(dev, pt, multigrid, i2p, p2i)
    res["oracles"] = dir_oracles(dev, pt)
    res["seconds"] = time.time() - t0
    log(f"dirichlet: phase 14 took {res['seconds']:.1f} s host clock")
    return res


def dirichlet_row(dr, key):
    """Phase 14's entries of one kernels-line row: its launches on each
    lifted solve (``launches_dirichlet``, counted just before the solve,
    read just after), on 14c's nu = 8 solve and on 14d's kernel='cuda'
    CG solves, and the lift forms held against plain (K9, K4, K6)."""
    ents = DIR_ENTRY.get(key, ())
    out = {"launches_dirichlet": {
        line: sum(c.get(e, 0) for e in ents)
        for line, c in dr["launches"].items()}}
    out["launches_dirichlet"]["14c_nu8"] = sum(
        dr["nu8"]["counts"].get(e, 0) for e in ents)
    for label, o in dr["oracles"].items():
        n = sum(o["counts"].get(e, 0) for e in ents)
        if n:
            out["launches_dirichlet"][f"14d {label}"] = n
    forms = {k: v for k, v in dr["forms"].items() if k.split()[0] == key}
    if forms:
        out["dirichlet_lift"] = forms
    return out


def dirichlet_summary(dr):
    """Phase 14's figures as one JSON-able dict."""
    keep = ("k", "k0", "solve_ms", "lift_ms", "lift_counts", "db", "true",
            "floor", "err64")
    return dict(
        lines={k: {f: v[f] for f in keep if f in v}
               for k, v in dr["lines"].items()},
        nu8={k: dr["nu8"][k] for k in ("k", "true", "floor", "calls", "k2",
                                       "ms")},
        oracles={k: {f: v[f] for f in ("err64", "err32", "true", "floor")}
                 for k, v in dr["oracles"].items()},
        forms={k: {f: v[f] for f in ("rel", "ms", "plain_ms", "bound_ms",
                                     "library_ms")}
               for k, v in dr["forms"].items()},
        seconds=dr["seconds"])


def run_dirichlet():
    """``python3 chip_smoke.py --dirichlet``: only phase 14 (with the
    kernel build); prints the card and one JSON line of its readings."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )

    log(card_line())
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    dr = phase_dirichlet(torch.device("cuda", 0), pt, multigrid, i2p, p2i)
    log(json.dumps({"dirichlet": dirichlet_summary(dr)}))
    log(card_line())
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    return 0


def bench3d_iters(dev, pt, multigrid, i2p):
    """Bench 3D's single-device PCG iterations (phase 4a's step)."""
    import torch

    n = N3
    conn, X, fixed, force, L = problem(n, n, n)
    model = pt.LinearElasticity("hex8", X, conn, fixed, None, force, p=0.0,
                                dtype=torch.float32, device=dev)
    asm = multigrid.GMGAssembler3D(
        n, n, n, *L, "elasticity", p=0.0, dtype=torch.float32, device=dev,
        nu_pre=2, nu_post=2, min_n=3, coarse_dense_max=4096,
        smoother_dtype=torch.bfloat16, omega="cheby")
    gmg, lv0 = asm.assemble(torch.ones(model.nnodes, dtype=torch.float32,
                                       device=dev))
    b = torch.where(lv0.mask, 0.0,
                    i2p(model.compute_rhs(), 3).reshape(3, n, n, n))
    return multigrid.pcg_gmg(gmg, lv0, b, rtol=1e-6, maxiter=200,
                             flexible=True)[1]


def phase_direct(dev, pt):
    """Phase 6b: host scipy direct solves against the card's CG on small
    jittered meshes (quad4 257x129 both models; tet10 and brick20 on a
    9^3 lattice, elasticity).  float64 einsum: CG (rtol 1e-12) vs direct
    by p^T u and relative L2.  float32: kernel="cuda" against
    kernel="einsum" by the float64 true residuals of their CG solves."""
    import torch

    for etype, ctype, dims, physics in (
        ("quad4", "quad", (257, 129), "elasticity"),
        ("quad4", "quad", (257, 129), "poisson"),
        ("tet10", "tet", (9, 9, 9), "elasticity"),
        ("brick20", "brick20", (9, 9, 9), "elasticity"),
    ):
        mesh = elem_problem(dims, ctype, SEED + 50)
        rho = density(etype, mesh[1], SEED + 51)
        label = f"6b {etype} {'x'.join(map(str, dims))} {physics}"
        make = lambda dtype, kernel: make_model(  # noqa: E731
            pt, physics, etype, mesh, dtype, kernel, dev)
        m64 = make(torch.float64, "einsum")
        u_cg = m64.solve(method="cg", rho=rho, rtol=1e-12)
        it = m64.last_solve_stats["iters"]
        u_d = m64.solve(method="direct", rho=rho).to(dev)
        p_vec = torch.as_tensor(np.random.RandomState(123).rand(m64.ndof),
                                device=dev)
        ptu = lambda v: float(p_vec @ v.double())  # noqa: E731
        rel_ptu = abs(ptu(u_cg) - ptu(u_d)) / abs(ptu(u_d))
        rel_l2 = float(torch.linalg.norm(u_cg - u_d) / torch.linalg.norm(u_d))
        log(f"{label} float64 einsum: card CG ({it} iterations, rtol "
            f"1e-12) vs host scipy direct: p^T u rel {rel_ptu:.3e}, u rel "
            f"L2 {rel_l2:.3e}")
        check(rel_ptu <= 1e-10, f"{label} float64 p^T u within 1e-10")
        check(rel_l2 <= 1e-6, f"{label} float64 u within 1e-6 (rel L2)")
        Ke64 = m64.element_jacobian(rho)
        b = m64.bc.constrain_rhs(m64.compute_rhs(),
                                 lambda v: m64.matvec(Ke64, v))
        res = {}
        for kernel in ("cuda", "einsum"):
            m = make(torch.float32, kernel)
            u = m.solve(method="cg", rho=rho, rtol=1e-6)
            res[kernel] = bc_residuals(m64, Ke64, b, u) + (
                m.last_solve_stats["iters"],
                float(torch.linalg.norm(u.double() - u_d)
                      / torch.linalg.norm(u_d)))
        (tc, fc, ic, lc), (te, fe, ie, le) = res["cuda"], res["einsum"]
        log(f"{label} float32 CG rtol 1e-6: kernel=cuda {ic} iterations, "
            f"true residual {tc:.3e}, u rel L2 vs direct {lc:.3e}; "
            f"kernel=einsum {ie} iterations, true residual {te:.3e}, u rel "
            f"L2 {le:.3e}; float32 floor {fc:.3e}")
        check(tc <= 2.0 * te, f"{label} float32 kernel=cuda true residual "
              f"<= 2 x kernel=einsum's")


def phase_scipy(dev, pt, multigrid, i2p, p2i, dims):
    """Phases 6 / 6a: p^T u against scipy's float64 sparse direct solve."""
    import scipy.sparse.linalg as spla
    import torch

    dim = len(dims)
    nd = dim
    shape = dims[::-1]
    label = "x".join(map(str, dims))
    conn, X, fixed, force, L = problem(*dims)
    nn = int(np.prod(dims))
    rho_s = np.random.default_rng(SEED + 2).uniform(0.3, 1.0, nn)
    m = pt.LinearElasticity("quad4" if dim == 2 else "hex8", X, conn, fixed,
                            None, force, p=3.0, dtype=torch.float32,
                            device=dev)
    m.attach_structured_grid(*dims)
    um = m.solve(method="gmg", rho=rho_s, rtol=1e-6)
    if dim == 2:
        op = lambda d: f64_operator(*dims, *L, torch.as_tensor(rho_s), 3.0, d)
        asm = multigrid.GMGAssembler(*dims, *L, "elasticity", p=3.0,
                                     device=dev)
    else:
        op = lambda d: f64_operator_3d(dims[0], L, torch.as_tensor(rho_s),
                                       3.0, d)
        asm = multigrid.GMGAssembler3D(*dims, *L, "elasticity", p=3.0,
                                       device=dev)
    mv64, mvabs, c64 = op("cpu")
    b = torch.where(m.bc.mask.cpu(), 0.0,
                    m.compute_rhs().cpu().to(torch.float64))
    bp = i2p(b, nd).reshape((nd,) + shape)
    K = scipy_csr(c64, shape)
    u_ref = p2i(torch.as_tensor(spla.spsolve(K, bp.reshape(-1).numpy())),
                nd).numpy()
    p_vec = np.random.RandomState(123).rand(m.ndof)
    ptu = lambda u: float(p_vec @ np.asarray(u, np.float64))
    rel = abs(ptu(um.cpu()) - ptu(u_ref)) / abs(ptu(u_ref))
    true, floor = residuals(mv64, mvabs, bp,
                            i2p(um.cpu(), nd).reshape((nd,) + shape))
    log(f"{label} float32 gmg: p^T u rel err vs scipy {rel:.3e}; true "
        f"residual {true:.3e} (floor {floor:.3e})")
    check(true <= FLOOR_FACTOR * floor,
          f"{label} true residual <= {FLOOR_FACTOR:g} x float32 floor")
    g32, _ = asm.assemble(torch.as_tensor(rho_s, dtype=torch.float32,
                                          device=dev))
    mv64d, _, _ = op(dev)
    xa, ka, _ = accuracy_solve(g32, mv64d, bp.to(dev))
    rel_a = abs(ptu(p2i(xa.reshape(-1), nd).cpu()) - ptu(u_ref)) / abs(
        ptu(u_ref))
    log(f"{label} float64 outer PCG ({ka} iterations): p^T u rel err vs "
        f"scipy {rel_a:.3e}")
    check(rel_a <= 1e-5, f"{label} p^T u within 1e-5 of scipy")


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import pyfem_gpu_testflight_tpu_torch as pt
    from pyfem_gpu_testflight_tpu_torch import multigrid
    from pyfem_gpu_testflight_tpu_torch.ops import _cuda
    from pyfem_gpu_testflight_tpu_torch.ops.dia import (
        interleave_to_planar as i2p, planar_to_interleave as p2i,
    )

    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    # 2. build
    t0 = time.time()
    _cuda.library()
    log(f"build: {time.time() - t0:.2f} s")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    # 3, 3a, 3b. kernels vs plain
    kres = phase_kernels(dev, _cuda.build_log)
    kres.update(phase_kernels_3d(dev, _cuda.build_log))
    kres.update(phase_kernels_otf(dev, _cuda.build_log))
    # 3c. element stiffness
    kres.update(phase_kernels_elem(dev, pt, _cuda.build_log))
    # 3d, 3e. the 2D stencil product and the half-symmetric 2D storage
    kres.update(phase_kernels_k9(dev))
    kres.update(phase_kernels_sym2d(dev))

    # 4, 4a, 4b, 4c, 4d. main paths
    m2 = phase_main_2d(dev, pt, multigrid, i2p, p2i)
    c2, s2, ch2 = m2["counts"], m2["single_ms"], m2["ch"]
    m3 = phase_main_3d(dev, pt, multigrid, i2p, p2i)
    c3 = m3["counts"]
    check(all(c3[k] > 0 for k in (
        "pyfem_assemble_3d", "pyfem_sweep_3d", "pyfem_sweeps_3d")),
        "bench 3D: K3, K4 and K5 launched")
    mo = phase_main_3d(dev, pt, multigrid, i2p, p2i, "bench 3D otf",
                       elem_path="otf")
    co = mo["counts"]
    check(co["pyfem_otf_3d_tc"] > 0 and co["pyfem_assemble_3d"] == 1,
          "bench 3D otf: K6 launched, K3 once (the coarsest level)")
    # per V-cycle and OTF level: presmooth (elementwise + nu - 1 sweeps +
    # residual) and nu postsweeps, all with bf16 operands; the PCG
    # matvec (float32) once per iteration on the fine level
    passes = (mo["k"] + 1) * (mo["nlevels"] - 1) * (2 + 1 + 2)
    f32 = mo["by_level"].get("pyfem_otf_3d", {})
    check(co["pyfem_otf_3d_tc"] == passes and co["pyfem_otf_3d"] == mo["k"]
          and set(f32) == {N3},
          f"bench 3D otf: the tensor-core entry runs all {passes} bf16 "
          f"smoother passes, the float32 entry only the {mo['k']} PCG "
          f"matvecs at {N3}^3")
    log(f"device time of one assemble+solve (device rows): bench 3D "
        f"{DEVICE_MS.get('bench 3D', float('nan')):.3f} ms, bench 3D otf "
        f"{DEVICE_MS.get('bench 3D otf', float('nan')):.3f} ms ({card})")
    check(mo["levels"][:-1] == ["OTFLevel"] * (len(mo["levels"]) - 1),
          "bench 3D otf: every level but the coarsest is on the fly")
    check(mo["k"] <= 8 and abs(mo["k"] - m3["k"]) <= 2,
          "bench 3D otf: <= 8 iterations, within 2 of the assembled route")
    du = float((mo["u"] - m3["u"]).abs().max() / m3["u"].abs().max())
    log(f"bench 3D otf vs assembled: {mo['k']} vs {m3['k']} iterations, "
        f"solution rel diff {du:.3e}, max-abs errors against the "
        f"float64-outer solution {mo['err64']:.3e} vs {m3['err64']:.3e}; "
        f"peak memory {mo['mem'] / 2**20:.1f} vs {m3['mem'] / 2**20:.1f} "
        f"MiB; single-shot {mo['single_ms']:.3f} vs {m3['single_ms']:.3f} "
        f"ms, chained {mo['ch']:.3f} vs {m3['ch']:.3f} ms/solve")
    mf = phase_main_3d(dev, pt, multigrid, i2p, p2i, "bench 3D sym=False",
                       full=False, sym=False)
    check(mf["counts"]["pyfem_sweep_3d"] > 0
          and mf["counts"]["pyfem_sweeps_3d"] > 0,
          "bench 3D sym=False: K4 and K5 launched on full planes")
    log(f"bench 3D sym=False: {mf['k']} iterations, single-shot "
        f"{mf['single_ms']:.3f} ms, peak memory {mf['mem'] / 2**20:.1f} "
        f"MiB")
    m2c = phase_main_2d(dev, pt, multigrid, i2p, p2i,
                        "bench 2D elem_path=cuda", elem_path="cuda")
    check(m2c["k"] <= 8 and abs(m2c["k"] - m2["k"]) <= 1,
          "bench 2D elem_path=cuda: <= 8 iterations, within 1 of phase 4")
    du2 = float((m2c["u"] - m2["u"]).abs().max() / m2["u"].abs().max())
    log(f"bench 2D elem_path=cuda vs uniform: {m2c['k']} vs {m2['k']} "
        f"iterations, solution rel diff {du2:.3e} (max-abs; rel L2 errors "
        f"against the float64-outer solution {m2c['err']:.3e} vs "
        f"{m2['err']:.3e}); true residual "
        f"{m2c['true']:.3e} vs {m2['true']:.3e}; hierarchy assembly "
        f"{m2c['asm_ms']:.3f} vs {m2['asm_ms']:.3f} ms; single-shot "
        f"{m2c['single_ms']:.3f} vs {m2['single_ms']:.3f} ms, chained "
        f"{m2c['ch']:.3f} vs {m2['ch']:.3f} ms/solve; peak memory "
        f"{m2c['mem'] / 2**20:.1f} vs {m2['mem'] / 2**20:.1f} MiB")

    m2s = phase_main_2d(dev, pt, multigrid, i2p, p2i, "bench 2D sym",
                        sym=True)
    check(m2s["k"] <= 8 and abs(m2s["k"] - m2["k"]) <= 1,
          "bench 2D sym: <= 8 iterations, within 1 of phase 4")
    log(f"bench 2D sym vs full storage: {m2s['k']} vs {m2['k']} iterations; "
        f"true residual {m2s['true']:.3e} vs {m2['true']:.3e}; hierarchy "
        f"assembly {m2s['asm_ms']:.3f} vs {m2['asm_ms']:.3f} ms; "
        f"single-shot {m2s['single_ms']:.3f} vs {m2['single_ms']:.3f} ms, "
        f"chained {m2s['ch']:.3f} vs {m2['ch']:.3f} ms/solve; peak memory "
        f"{m2s['mem'] / 2**20:.1f} vs {m2['mem'] / 2**20:.1f} MiB")

    # 5, 5a, 5b. model entry point
    phase_model(dev, pt, "quad4", (NX, NY), "2D")
    phase_model(dev, pt, "hex8", (N3, N3, N3), "3D")
    phase_model(dev, pt, "hex8", (N3, N3, N3), "3D otf", elem_path="otf")
    # 5c, 5d. the general-mesh element path
    g5c = phase_general(dev, pt, "5c", "elasticity")
    g5d = phase_general(dev, pt, "5d", "poisson")
    g5e = phase_general(dev, pt, "5e", "poisson", "quad4", (NX, NY))

    # 6, 6a, 6b. scipy checks
    phase_scipy(dev, pt, multigrid, i2p, p2i, (257, 129))
    phase_scipy(dev, pt, multigrid, i2p, p2i, (17, 17, 17))
    phase_direct(dev, pt)

    # 7. topology optimization at the bench width
    topo = phase_topo(dev, pt, i2p)
    # 8. the nonlinear Poisson Newton solve at the bench newton width
    newton = phase_newton(dev, pt)
    # 9. p-multigrid on the bench quadratic lattice
    quad = phase_quadratic(dev, pt)
    # 10. 3D topology optimization at bench topo --topo-3d's width, its
    # scale line and the 3D einsum route
    topo3d = phase_topo3d(dev, pt, multigrid, i2p)
    # 11. unstructured meshes: the torque arm and the C3D10 bracket
    uns = phase_unstructured(dev, pt)
    # 12. the user-facing surface: post-processing, KS and its adjoint,
    # natural frequencies, the profiler and the examples
    surf = phase_surface(dev, pt, multigrid, i2p, p2i)
    # 13. the multi-rank solvers: world 1 on NCCL, two gloo ranks on the
    # card, the dry run
    sh = phase_sharded(dev, pt, dict(k2d=m2["k"], k3d=m3["k"],
                                     k_arm=uns["arm"]["solve"]["iters"]),
                       uns["arm"].pop("system"))
    # 14. GMG solves with nonzero Dirichlet values (the rhs lift on K9 /
    # K4 / K6), nu = 8 at the bench width, the oracle gates on the card
    dr = phase_dirichlet(dev, pt, multigrid, i2p, p2i)

    # summary
    src = "pyfem_gpu_testflight_tpu_torch/csrc/"
    tpu = "pyfem_gpu_testflight_tpu/ops/"
    rows = (
        ("K1", "assemble_pack_2d", "assemble_2d.cu", "pallas_assemble.py:192",
         c2["pyfem_assemble_2d"], "full 36-plane storage, one pass: "
         "compacted weights in the constant bank (launch parameters), "
         "materials staged once per element, two nodes a thread; from "
         "65536 nodes at nd=2 each (a, b) block's planes staged in shared "
         "memory and written as windows of whole 32-byte sectors, below "
         "it (and at nd=1) 4 x 32-pair tiles storing directly (main path: "
         "bench 2D, once per level)"),
        ("K2", "fused_sweeps_2d", "smooth_2d.cu", "pallas_smooth.py:369",
         c2["K2"], "full storage, one launch per smoothing call (sweeps "
         "and residual, each block a tile plus a ghost ring, coefficients "
         "in registers read once; timed: bench 2D's presmooth_resid on "
         "bf16 planes; forms: every call form at 1025x513 nd=2 with "
         "launches per call; niter 0: one stencil step)"),
        ("K3", "assemble_pack_3d", "assemble_3d.cu", "pallas_assemble.py:584",
         c3["pyfem_assemble_3d"], "both storages, one pass: half-symmetric "
         "123 planes (timed, main path) and full 243 planes (full_form); "
         "compacted weights in shared memory, materials staged once per "
         "element, two x-adjacent nodes a thread"),
        ("K4", "fused_sweep_3d", "smooth_3d.cu", "pallas_smooth.py:697",
         c3["pyfem_sweep_3d"], "both bodies, one pass: _kernel3d_sym "
         "(timed, main path) and _kernel3d on full planes (full_form)"),
        ("K5", "fused_sweeps3d", "smooth_3d.cu", "pallas_smooth.py:972",
         c3["pyfem_sweeps_3d"], "per-sweep: one stencil pass per sweep "
         "and one for the residual (not the single-pass z-blocked form); "
         "reads either storage"),
        ("K6", "otf_apply_3d", "otf_3d.cu", "pallas_otf3d.py:265",
         co["pyfem_otf_3d"], "f32 body on the CUDA cores (pyfem_otf_3d): "
         "one stencil pass per launch, coefficients rebuilt per node from "
         "the density (main path: bench 3D otf, the PCG matvecs)"),
        ("K6-tc", "otf_apply_3d(mxu_bf16=True)", "otf_3d.cu",
         "pallas_otf3d.py:265", co["pyfem_otf_3d_tc"],
         "bf16-operand pass on the tensor cores (pyfem_otf_3d_tc): "
         "mma.sync m16n8k16 per element offset, one stencil pass per "
         "launch (main path: bench 3D otf, every smoother pass; timed: a "
         "sweep pass)"),
        ("K7a", "elasticity_stiffness_quad4", "stiffness_2d.cu",
         "pallas_stiffness.py:163", m2c["counts"]["pyfem_elasticity_quad4"],
         "one thread per element, upper triangle mirrored (main path: "
         "4d, once per GMG level; timed at 1025x513 jittered)"),
        ("K7b", "poisson_stiffness_quad4", "stiffness_2d.cu",
         "pallas_stiffness.py:205", g5e["st"]["launches"],
         "one thread per element, upper triangle mirrored (main path: 5e "
         "LinearPoisson quad4 kernel='cuda' CG solve at 1025x513)"),
        ("K8", "elasticity_stiffness_3d / poisson_stiffness_3d",
         "stiffness_3d.cu", "pallas_stiffness3d.py:231",
         g5c["st"]["launches"],
         "a block per element group: geometry once per element in shared "
         "memory, a thread per node pair of the upper triangle, mirrored, "
         "Ke written element-major (hex8 elasticity timed, main path 5c; "
         "forms)"),
    )
    cs = m2s["counts"]
    rows += (
        ("K1-sym", "assemble_pack_2d(sym=True)", "assemble_2d.cu",
         "pallas_assemble.py:192", cs["pyfem_assemble_2d_sym"],
         "half-symmetric storage, 19 of 36 planes (5 of 9 at nd=1), one "
         "pass, K1's design (main path: bench 2D sym, once per level)"),
        ("K2-sym", "fused_sweeps_2d (sym planes)", "smooth_2d.cu",
         "pallas_smooth.py:369", cs["K2-sym"],
         "half-symmetric storage, one launch per smoothing call (K2's "
         "design, the kept planes staged on the region plus a ring of one "
         "for the partner terms; timed: bench 2D sym's presmooth_resid on "
         "bf16 planes; forms: every call form at 1025x513 nd=2 with "
         "launches per call; niter 0: one stencil step) (main path: bench "
         "2D sym)"),
        ("K9", "stencil_matvec_2d", "stencil_2d.cu", "pallas_stencil.py:56",
         topo["k9_launches"],
         "one thread per node, all nd outputs, f32 and f64 (main path: "
         f"topo, {TOPO_ITERS} MMA iterations; timed form nd=1 f32, the "
         "filter's)"),
    )
    kernels = []
    kres["K8"] = dict(kres["K8 hex8 elasticity"], max_abs_err=max(
        [v["max_abs_err"] for k, v in kres.items() if k.startswith("K8 ")]
        + [g5c["err"], g5d["err"]]))
    kres["K7b"]["max_abs_err"] = max(kres["K7b"]["max_abs_err"], g5e["err"])
    for key, name, source, replaces, launches, form in rows:
        r = kres[key]
        row = dict(
            name=name, route="cuda", source=src + source,
            replaces=tpu + replaces, launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_us=1e3 * r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], form=form,
        )
        if f"{key} full" in kres:
            f = kres[f"{key} full"]
            row["full_form"] = dict(
                max_abs_err=f["max_abs_err"], ms=f["ms"],
                device_ms=f["device_ms"],
                plain_ms=f["plain_ms"], bound_ms=f["bound_ms"],
                bound_by=f["bound_by"], library_ms=f["library_ms"],
                launches_sym_false_path=mf["counts"][
                    "pyfem_assemble_3d" if key == "K3" else "pyfem_sweep_3d"])
        if key == "K8":
            row["launches_5d"] = g5d["st"]["launches"]
            row["launches_unstructured_bracket"] = uns["bracket"]["solve"][
                "counts"]["pyfem_stiffness_3d"]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     uns["bracket"]["k8_err"])
            row["forms"] = {
                k[3:]: dict(max_abs_err=v["max_abs_err"], ms=v["ms"],
                            device_ms=v["device_ms"],
                            plain_ms=v["plain_ms"], bound_ms=v["bound_ms"],
                            bound_by=v["bound_by"], ptxas=v["ptxas"])
                for k, v in kres.items() if k.startswith("K8 ")}
        for extra in ("ptxas", "levels_device_ms"):
            if extra in r:
                row[extra] = r[extra]
        if "device_ms" in r:
            row["device_ms"] = r["device_ms"]
        if key == "K6-tc":
            row["f32_pass_device_ms"] = r["f32_pass_device_ms"]
            row["f32_pass_ms"] = r["f32_pass_ms"]
        if key == "K9":
            row["launches_per_mma_iteration"] = topo["k9_per_iter"]
            row["forms"] = r["forms"]
        if key == "K2":
            row["forms"] = r["forms"]
            row["launches_per_bench_2d_solve"] = c2["K2"]
        # phase 8's counts (its main path: bench newton) and its nd=1
        # forms at 1025^2 on the path's own inputs
        nk = newton["kernels"]
        if key == "K1":
            row["launches_newton"] = newton["counts"]["pyfem_assemble_2d"]
            row["newton_nd1"] = nk["K1"]
        if key == "K2":
            row["launches_newton"] = newton["counts"]["K2"]
            row["newton_nd1"] = nk["K2"]
        if key == "K9":
            row["launches_newton"] = dict(f32=newton["k9"][0],
                                          f64=newton["k9"][1])
            row["newton_nd1"] = {k_[3:]: v for k_, v in nk.items()
                                 if k_.startswith("K9 ")}
        # phase 12's counts: 12a (elasticity, nd=2) and 12b (KS and its
        # adjoint, nd=1) for K1/K2, the topo example for K1/K2/K9 and
        # performance_study --kernel cuda for K8
        if key in ("K1", "K2", "K9", "K8"):
            entry = {"K1": "pyfem_assemble_2d", "K2": "K2",
                     "K9": "pyfem_stencil_2d", "K8": "pyfem_stiffness_3d"}[key]
            ex = surf["examples"]
            row["launches_surface"] = (
                {"performance_study": ex["performance_study"]["counts"][entry]}
                if key == "K8" else
                {"12a_elasticity": surf["elasticity"]["counts"][entry],
                 "12b_ks_adjoint": surf["ks"]["counts"][entry],
                 "topo_example": ex["topo"]["counts"][entry]})
        if key in ("K1", "K2", "K9"):
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                v["max_abs_err"] for k_, v in nk.items()
                if k_.split()[0] == key])
        # phase 9's counts (its main path: bench quadratic, and its
        # kernel="cuda", Chebyshev corner smoother and tet10 lines) and
        # the kernels held on its inputs
        if key in _QUAD_ENTRY:
            row["launches_quadratic"] = {
                line: c[_QUAD_ENTRY[key]]
                for line, c in quad["launches"].items()}
            row["max_abs_err"] = max(row["max_abs_err"],
                                     quad["kernels"][key]["max_abs_err"])
        # phase 10's counts over its timed MMA iterations (its main path:
        # bench topo --topo-3d and its scale line) and the einsum route's;
        # K4's nd=1 filter form held on each line's planes
        if key in ("K3", "K4", "K5"):
            lk = {"K3": ("K3",), "K4": ("K4_state", "K4_filter"),
                  "K5": ("K5",)}[key]
            row["launches_topo3d"] = {
                line: ({k_: topo3d[line]["launches"][k_] for k_ in lk}
                       if key == "K4" else topo3d[line]["launches"][lk[0]])
                for line in ("contract", "scale")}
            row["launches_topo3d"]["einsum_33"] = {
                route: c["launches"][_QUAD_ENTRY[key]]
                for route, c in topo3d["einsum"].items()
                if "einsum" in route}
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                topo3d[line]["kernels"][key]
                for line in ("contract", "scale")])
        if key == "K4":
            row["topo3d_filter_nd1"] = {
                "x".join(map(str, topo3d[line]["dims"])):
                    topo3d[line]["k4_filter"]
                for line in ("contract", "scale")}
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                topo3d[line]["k4_filter"]["max_abs_err"]
                for line in ("contract", "scale")])
        if key in ("K2", "K4", "K9"):
            row.update(sharded_row(sh, {"K2": "K2", "K4": "pyfem_sweep_3d",
                                        "K9": "pyfem_stencil_2d"}[key], key))
        row.update(dirichlet_row(dr, key))
        if "dirichlet_lift" in row:
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                v["max_abs_err"] for v in row["dirichlet_lift"].values()])
        kernels.append(row)
    kernels += unstructured_kernel_rows(uns)
    kernels[-2].update(sharded_row(sh, "pyfem_csr_spmv", "U1"))
    if FAILS:
        print("chip_smoke FAILED:\n  " + "\n  ".join(FAILS), file=sys.stderr)
        return 1
    log(f"topo: {topo['s_per_iter']:.4f} s per MMA iteration at "
        f"{NX}x{NY} ({card})")
    log(f"newton: {newton['k']} Newton iterations, single-shot "
        f"{newton['single']:.1f} ms, chained {newton['ch']:.1f} ms/solve, "
        f"true residual ratio {newton['ratio']:.3e}, peak memory "
        f"{newton['mem'] / 2**20:.1f} MiB at {NEWTON_N}x{NEWTON_N} ({card})")
    log(f"quadratic: brick20 {QUAD_N}^3, {quad['k']} PCG iterations, "
        f"cheb_lam {quad['lam']:.4f}, single-shot {quad['single']:.1f} ms, "
        f"chained {quad['ch']:.1f} ms/solve, peak memory "
        f"{quad['mem'] / 2**20:.1f} MiB; tet10 {QUAD_TET_N}^3 "
        f"{quad['k_tet']} iterations, {quad['single_tet']:.1f} ms ({card})")
    for line in ("contract", "scale"):
        o = topo3d[line]
        log(f"topo3d {line}: {'x'.join(map(str, o['dims']))}, "
            f"{o['s_per_iter']:.4f} s per MMA iteration (steady "
            f"{o['steady']:.4f}), state PCG {o['cg'][0]} -> {o['cg'][-1]} "
            f"iterations, compliance {o['objs'][0]:.5e} -> "
            f"{o['objs'][-1]:.5e}, volume {o['vol']:.5f}, peak "
            f"{o['mem'] / 2**20:.1f} MiB ({card})")
    ua, ub = uns["arm"], uns["bracket"]
    log(f"unstructured: arm {ua['ndof']} dof, {ua['solve']['iters']} "
        f"AMG-PCG iterations, solve {ua['solve']['wall_s']:.2f} s (PCG "
        f"{ua['solve']['pcg_s']:.3f} s), true residual {ua['res']:.2e}, "
        f"topo {ua['topo']['s_per_iter']:.2f} s per MMA iteration; bracket "
        f"{ub['ndof']} dof, {ub['solve']['iters']} iterations, solve "
        f"{ub['solve']['wall_s']:.2f} s ({card})")
    log(json.dumps({"unstructured": unstructured_summary(uns)}))
    se, sk, sc = surf["elasticity"], surf["ks"], surf["eigen"]["found"]
    log(f"surface: 1025x513 elasticity {se['iters']} PCG iterations, "
        f"Assembler.solve {se['ev_ms']['solve']:.3f} ms, strains "
        f"{se['ev_ms']['quadrature_strains']:.3f} ms, nodal strains "
        f"{se['ev_ms']['nodal_strains']:.3f} ms; KS chain {sk['ms']:.3f} "
        f"ms; LOBPCG meets rtol 1e-6 at {sc['grid']} ({card})")
    log(json.dumps({"surface": surface_summary(surf)}))
    log(json.dumps({"sharded": sharded_summary(sh)}))
    log(json.dumps({"dirichlet": dirichlet_summary(dr)}))
    log(f"2D single-shot {s2:.3f} ms, chained {ch2:.3f} ms/solve; 3D "
        f"single-shot {m3['single_ms']:.3f} ms, chained {m3['ch']:.3f} "
        f"ms/solve; 3D otf single-shot {mo['single_ms']:.3f} ms, chained "
        f"{mo['ch']:.3f} ms/solve ({card})")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(run_pass_levels() if "--pass-levels" in sys.argv else
             run_quadratic_floor() if "--quadratic-floor" in sys.argv else
             run_quadratic() if "--quadratic" in sys.argv else
             run_topo3d() if "--topo3d" in sys.argv else
             run_unstructured() if "--unstructured" in sys.argv else
             run_surface() if "--surface" in sys.argv else
             run_sharded() if "--sharded" in sys.argv else
             run_dirichlet() if "--dirichlet" in sys.argv else
             run_solution_floor() if "--solution-floor" in sys.argv else
             run_k2_witness() if "--k2-witness" in sys.argv else
             run_assembly_kernels() if "--assembly-kernels" in sys.argv
             else run_stencil_2d_kernels()
             if "--stencil-2d-kernels" in sys.argv
             else run_newton_floor() if "--newton-floor" in sys.argv
             else run_newton() if "--newton" in sys.argv
             else main())
