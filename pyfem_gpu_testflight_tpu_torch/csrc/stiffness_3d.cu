// K8: batched 3D element stiffness (hex8, tet10, brick20; isotropic
// elasticity in Lame form and Poisson) on an NVIDIA Hopper card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_stiffness3d.py: _call
//   (Pallas kernels _elasticity_kernel, _poisson_kernel,
//   _poisson_row_kernel), reached from elasticity_stiffness_3d and
//   poisson_stiffness_3d.
// Plain reference: ops/element_kernels3d.py::*_plain (the einsum path of
// ops/stiffness.py through a layout transpose).
//
// Layout (the JAX package's, element-minor): XeT (3nn, E) rows n*3 + i,
// cq (nq, E), KeT (ndpe^2, E) row r*ndpe + s = Ke[e, r, s] with
// ndpe = 3nn (elasticity) or nn (Poisson).  Per element: centroid-
// centered coordinates, then per quadrature point the 3x3 Jacobian, its
// adjugate inverse (the JAX _quad_geometry), c = cq * w * detJ and
//   elasticity: Ke[(n,a),(m,b)] += mu c (d_ab G_n.G_m + G_nb G_ma)
//                                  + lam c G_na G_mb
//   Poisson:    Ke[n, m]        += c G_n.G_m.
//
// What bounds it on the H100: hex8 elasticity writes 576 floats and
// reads 32 per element (2.4 KB): 638 MB at 65^3 (262,144 elements), 190
// us at 3.35 TB/s, and does ~3.5e4 flops per element (9.1 GFLOP, 136 us
// at 67 TFLOP/s): near the ridge, bytes first.  hex8 Poisson (64 floats
// out) is bytes-bound at ~30 us.  The quadratic elements do more
// flops per output (brick20: 27 points) and lean to operations.
// What the design does about it: one thread holds at most a block of
// output rows of one element (a thread cannot hold hex8 elasticity's 576
// accumulators), so the grid is (element blocks, row blocks): consecutive
// threads take consecutive elements of the same rows, and every store of
// the element-minor KeT is one coalesced 128-byte line per warp.  Row
// blocks: hex8 elasticity one row node (72 accumulators), hex8 Poisson
// the whole element (64), tet10/brick20 one row (3nn or nn: 30 / 60
// for elasticity, which at one node per thread would be 90 / 180 and
// spill).  Each row-block thread recomputes its element's geometry
// (the inputs are L2 hits after the first); sharing it through shared
// memory is later work.  hex8's shape derivatives are compile-time
// constants (the quadrature loop is unrolled and folds them into
// immediates); the quadratic elements' (nq, 3nn+1) table of derivatives
// and weights is copied to shared memory and read at block-uniform
// addresses (broadcasts), never walked per thread in the constant bank.
// A ragged last block is masked; nothing is padded.
#include <cuda_runtime.h>

namespace {

// 1/sqrt(3) as NumPy computes it (elements.py::_hex8_rule)
constexpr double kG = 1.0 / 1.7320508075688772;

// hex8 Gauss point q = 4 ix + 2 iy + iz (x slowest), coordinate d
__host__ __device__ constexpr double hex8_pt(int q, int d) {
  const int bit = d == 0 ? (q >> 2) & 1 : d == 1 ? (q >> 1) & 1 : q & 1;
  return bit ? kG : -kG;
}

// elements.py::_HEX8_SIGNS[n][d]
__host__ __device__ constexpr double hex8_sign(int n, int d) {
  const int c = n & 3;
  const bool plus = d == 0 ? (c == 1 || c == 2) : d == 1 ? (c >= 2) : (n >= 4);
  return plus ? 1.0 : -1.0;
}

// dN[q][n][d] of elements.py::_hex8_shape (same operation order), as float
__host__ __device__ constexpr float hex8_dn(int q, int n, int d) {
  const int o0 = d == 0 ? 1 : 0, o1 = d == 2 ? 1 : 2;
  const double t0 = 1.0 + hex8_sign(n, o0) * hex8_pt(q, o0);
  const double t1 = 1.0 + hex8_sign(n, o1) * hex8_pt(q, o1);
  return static_cast<float>(0.125 * hex8_sign(n, d) * t0 * t1);
}

__device__ __forceinline__ float sel3(const float (&v)[3], int a) {
  return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
}

// NN nodes, NQ points; RPT output rows per thread (row block
// blockIdx.y); HEX8: compile-time tables, else the shared-memory table
template <int NN, int NQ, bool ELASTIC, int RPT, bool HEX8>
__global__ void stiffness_3d_kernel(const float* __restrict__ XeT,
                                    const float* __restrict__ cq,
                                    const float* __restrict__ tab, float mu,
                                    float lam, int E,
                                    float* __restrict__ KeT) {
  constexpr int ND = ELASTIC ? 3 : 1;
  constexpr int NDPE = ND * NN;
  constexpr int TW = 3 * NN + 1;  // table row: dN (n*3 + k), then w_q
  __shared__ float s_tab[HEX8 ? 1 : NQ * TW];
  if constexpr (!HEX8) {
    for (int i = threadIdx.x; i < NQ * TW; i += blockDim.x) s_tab[i] = tab[i];
    __syncthreads();
  }
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long En = E;
  const int rb = blockIdx.y;

  float xc[3][NN];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int n = 0; n < NN; ++n) xc[i][n] = __ldg(XeT + (3 * n + i) * En + e);
    float mean = xc[i][0];
#pragma unroll
    for (int n = 1; n < NN; ++n) mean += xc[i][n];
    mean *= 1.f / NN;
#pragma unroll
    for (int n = 0; n < NN; ++n) xc[i][n] -= mean;
  }

  float acc[RPT][NDPE];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int s = 0; s < NDPE; ++s) acc[i][s] = 0.f;

  auto point = [&](int q) {
    auto dn = [&](int n, int k) -> float {
      if constexpr (HEX8) return hex8_dn(q, n, k);
      else return s_tab[q * TW + 3 * n + k];
    };
    float J[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float t = dn(0, k) * xc[i][0];
#pragma unroll
        for (int n = 1; n < NN; ++n) t += dn(n, k) * xc[i][n];
        J[i][k] = t;
      }
    const float c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
    const float c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
    const float c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
    const float c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
    const float c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
    const float c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
    const float c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
    const float c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
    const float c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
    const float detJ = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
    const float inv_det = 1.f / detJ;
    // invJ[m][l] = dxi_m / dx_l
    const float invJ[3][3] = {
        {c00 * inv_det, c10 * inv_det, c20 * inv_det},
        {c01 * inv_det, c11 * inv_det, c21 * inv_det},
        {c02 * inv_det, c12 * inv_det, c22 * inv_det}};
    float w = 1.f;  // hex8 weights are 1
    if constexpr (!HEX8) w = s_tab[q * TW + 3 * NN];
    const float c = __ldg(cq + q * En + e) * (w * detJ);
    const float cmu = mu * c, clam = lam * c;

    auto grad = [&](int n, float (&g)[3]) {
#pragma unroll
      for (int l = 0; l < 3; ++l)
        g[l] = dn(n, 0) * invJ[0][l] + dn(n, 1) * invJ[1][l] +
               dn(n, 2) * invJ[2][l];
    };
    float G[HEX8 ? NN : 1][3];  // hex8: every node's gradient, folded
    if constexpr (HEX8) {
#pragma unroll
      for (int m = 0; m < NN; ++m) grad(m, G[m]);
    }
    // the thread's rows: node nR[i], component aR[i], gradient GR[i]
    float GR[RPT][3];
    int aR[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = RPT == NDPE ? i : rb * RPT + i;
      const int n = r / ND;
      aR[i] = r % ND;
      if constexpr (HEX8) {
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          float v = G[0][l];
#pragma unroll
          for (int m = 1; m < NN; ++m) v = n == m ? G[m][l] : v;
          GR[i][l] = v;
        }
      } else {
        grad(n, GR[i]);  // block-uniform n: shared-memory broadcasts
      }
    }
#pragma unroll
    for (int m = 0; m < NN; ++m) {
      float Gm[3];
      if constexpr (HEX8) {
#pragma unroll
        for (int l = 0; l < 3; ++l) Gm[l] = G[m][l];
      } else {
        grad(m, Gm);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float gg = GR[i][0] * Gm[0] + GR[i][1] * Gm[1] + GR[i][2] * Gm[2];
        if constexpr (ELASTIC) {
          const int a = aR[i];
          const float Gna = sel3(GR[i], a), Gma = sel3(Gm, a);
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            float t = cmu * (GR[i][b] * Gma) + clam * (Gna * Gm[b]);
            if (a == b) t += cmu * gg;
            acc[i][3 * m + b] += t;
          }
        } else {
          acc[i][m] += c * gg;
        }
      }
    }
  };

  if constexpr (HEX8) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) point(q);
  } else {
#pragma unroll 1
    for (int q = 0; q < NQ; ++q) point(q);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = RPT == NDPE ? i : rb * RPT + i;
#pragma unroll
    for (int s = 0; s < NDPE; ++s) KeT[(r * NDPE + s) * En + e] = acc[i][s];
  }
}

constexpr int kBlock = 128;

template <int NN, int NQ, bool ELASTIC, int RPT, bool HEX8>
int launch(const void* XeT, const void* cq, const void* tab, float mu,
           float lam, int E, void* KeT, cudaStream_t s) {
  constexpr int NDPE = (ELASTIC ? 3 : 1) * NN;
  const dim3 grid((E + kBlock - 1) / kBlock, NDPE / RPT);
  stiffness_3d_kernel<NN, NQ, ELASTIC, RPT, HEX8><<<grid, kBlock, 0, s>>>(
      static_cast<const float*>(XeT), static_cast<const float*>(cq),
      static_cast<const float*>(tab), mu, lam, E, static_cast<float*>(KeT));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nn: 8 (hex8, 8 points), 10 (tet10, 5 points) or 20 (brick20, 27
// points); tab: (nq, 3nn+1) float table for tet10/brick20 (unused, may
// be null, for hex8)
extern "C" int pyfem_stiffness_3d(const void* XeT, const void* cq,
                                  const void* tab, float mu, float lam,
                                  int elastic, int nn, int E, void* KeT,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nn == 8)
    return elastic ? launch<8, 8, true, 3, true>(XeT, cq, tab, mu, lam, E, KeT, s)
                   : launch<8, 8, false, 8, true>(XeT, cq, tab, mu, lam, E, KeT, s);
  if (tab == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (nn == 10)
    return elastic ? launch<10, 5, true, 1, false>(XeT, cq, tab, mu, lam, E, KeT, s)
                   : launch<10, 5, false, 1, false>(XeT, cq, tab, mu, lam, E, KeT, s);
  if (nn == 20)
    return elastic ? launch<20, 27, true, 1, false>(XeT, cq, tab, mu, lam, E, KeT, s)
                   : launch<20, 27, false, 1, false>(XeT, cq, tab, mu, lam, E, KeT, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
