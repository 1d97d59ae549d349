// K7: batched quad4 element stiffness on an NVIDIA Hopper card —
// plane-stress elasticity in Lame form (K7a) and Poisson (K7b).
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_stiffness.py:
//   elasticity_stiffness_quad4 (Pallas kernel _elasticity_kernel) and
//   poisson_stiffness_quad4 (_poisson_kernel).
// Plain reference: ops/element_kernels.py::*_plain (the einsum path of
// ops/stiffness.py through a layout transpose).
//
// Layout (the JAX package's, element-minor): XeT (8, E) rows n*2 + i,
// cq (4, E) RAMP factor at the quad points, KeT (ndpe^2, E) row
// r*ndpe + s = Ke[e, r, s], ndpe = 8 (elasticity) or 4 (Poisson).
// Per element: centroid-centered coordinates (float32 conditioning, as
// the JAX _center), then per Gauss point the 2x2 Jacobian, its inverse,
// the shape gradients G[n][l], c = cq * w * detJ and
//   elasticity: Ke[(n,a),(m,b)] += mu c (d_ab G_n.G_m + G_nb G_ma)
//                                  + lam c G_na G_mb
//   Poisson:    Ke[n, m]        += c G_n.G_m.
//
// What bounds it on the H100: bytes.  K7a reads 12 floats and writes 64
// per element (304 B): 159 MB at 1025x513 (524,288 elements), ~48 us at
// 3.35 TB/s, against ~1,500 flops per element (~12 us at 67 TFLOP/s).
// K7b writes 16 floats (112 B per element, ~18 us).
// What the design does about it: one thread per element, consecutive
// threads on consecutive elements, so every load and every one of the
// ndpe^2 stores is one coalesced 128-byte line per warp.  The quad4
// shape derivatives and weights are compile-time constants (folded into
// immediates by the full unroll); only the upper triangle is
// accumulated (36 / 10 registers) and mirrored, so Ke is exactly
// symmetric.  A ragged last block is masked; nothing is padded.
#include <cuda_runtime.h>

namespace {

// 1/sqrt(3) computed as NumPy computes it (elements.py), so the float
// tables below round exactly as the element tables do
constexpr double kG = 1.0 / 1.7320508075688772;

// quad4 Gauss points in the reference order (-g,-g), (g,-g), (g,g), (-g,g)
__host__ __device__ constexpr double q4_xi(int q) {
  return (q == 1 || q == 2) ? kG : -kG;
}
__host__ __device__ constexpr double q4_eta(int q) {
  return q >= 2 ? kG : -kG;
}

// dN[q][n][k] of elements.py::_quad4_shape, rounded to float
__host__ __device__ constexpr float q4_dn(int q, int n, int k) {
  const double xi = q4_xi(q), eta = q4_eta(q);
  const double v =
      n == 0 ? (k == 0 ? -(1 - eta) : -(1 - xi))
    : n == 1 ? (k == 0 ? (1 - eta) : -(1 + xi))
    : n == 2 ? (k == 0 ? (1 + eta) : (1 + xi))
             : (k == 0 ? -(1 + eta) : (1 - xi));
  return static_cast<float>(0.25 * v);
}

template <bool ELASTIC>
__global__ void stiffness_quad4_kernel(const float* __restrict__ XeT,
                                       const float* __restrict__ cq,
                                       float mu, float lam, int E,
                                       float* __restrict__ KeT) {
  constexpr int NDPE = ELASTIC ? 8 : 4;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const long long En = E;

  float x[4], y[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    x[n] = __ldg(XeT + (2 * n) * En + e);
    y[n] = __ldg(XeT + (2 * n + 1) * En + e);
  }
  const float xm = 0.25f * (((x[0] + x[1]) + x[2]) + x[3]);
  const float ym = 0.25f * (((y[0] + y[1]) + y[2]) + y[3]);
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    x[n] -= xm;
    y[n] -= ym;
  }

  float acc[NDPE][NDPE];
#pragma unroll
  for (int r = 0; r < NDPE; ++r)
#pragma unroll
    for (int s = 0; s < NDPE; ++s) acc[r][s] = 0.f;

#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float J00 = 0.f, J01 = 0.f, J10 = 0.f, J11 = 0.f;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      J00 += q4_dn(q, n, 0) * x[n];
      J01 += q4_dn(q, n, 1) * x[n];
      J10 += q4_dn(q, n, 0) * y[n];
      J11 += q4_dn(q, n, 1) * y[n];
    }
    const float detJ = J00 * J11 - J01 * J10;
    const float inv_det = 1.f / detJ;
    // invJ[m][l] = dxi_m / dx_l
    const float i00 = J11 * inv_det, i01 = -J01 * inv_det;
    const float i10 = -J10 * inv_det, i11 = J00 * inv_det;
    float G[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      G[n][0] = q4_dn(q, n, 0) * i00 + q4_dn(q, n, 1) * i10;
      G[n][1] = q4_dn(q, n, 0) * i01 + q4_dn(q, n, 1) * i11;
    }
    const float c = __ldg(cq + q * En + e) * detJ;  // quad4 weights are 1
    if constexpr (ELASTIC) {
      const float cmu = mu * c, clam = lam * c;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float gg = G[n][0] * G[m][0] + G[n][1] * G[m][1];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int r = 2 * n + a, s = 2 * m + b;
              if (r > s) continue;
              float t = cmu * (G[n][b] * G[m][a]) + clam * (G[n][a] * G[m][b]);
              if (a == b) t += cmu * gg;
              acc[r][s] += t;
            }
        }
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int m = n; m < 4; ++m)
          acc[n][m] += c * (G[n][0] * G[m][0] + G[n][1] * G[m][1]);
    }
  }

#pragma unroll
  for (int r = 0; r < NDPE; ++r)
#pragma unroll
    for (int s = 0; s < NDPE; ++s)
      KeT[(r * NDPE + s) * En + e] = r <= s ? acc[r][s] : acc[s][r];
}

constexpr int kBlock = 128;

}  // namespace

extern "C" int pyfem_elasticity_quad4(const void* XeT, const void* cq,
                                      float mu, float lam, int E, void* KeT,
                                      void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stiffness_quad4_kernel<true>
      <<<(E + kBlock - 1) / kBlock, kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(XeT), static_cast<const float*>(cq), mu,
          lam, E, static_cast<float*>(KeT));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pyfem_poisson_quad4(const void* XeT, const void* cq, int E,
                                   void* KeT, void* stream) {
  if (E <= 0) return static_cast<int>(cudaErrorInvalidValue);
  stiffness_quad4_kernel<false>
      <<<(E + kBlock - 1) / kBlock, kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(XeT), static_cast<const float*>(cq), 0.f,
          0.f, E, static_cast<float*>(KeT));
  return static_cast<int>(cudaGetLastError());
}
