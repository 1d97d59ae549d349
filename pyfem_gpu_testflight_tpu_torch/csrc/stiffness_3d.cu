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
// Layout: inputs element-minor as in the JAX package, XeT (3nn, E) rows
// n*3 + i and cq (nq, E); the output element-major, Ke (E, ndpe, ndpe)
// contiguous with ndpe = 3nn (elasticity) or nn (Poisson), the layout
// the matrix-free operator reads (the wrapper hands out the JAX-named
// KeT (ndpe^2, E) as its transposed view).  Per element: centroid-
// centred coordinates, then per quadrature point the 3x3 Jacobian, its
// adjugate inverse (the JAX _quad_geometry), c = cq * w * detJ and
//   elasticity: Ke[(n,a),(m,b)] += mu c (d_ab G_n.G_m + G_nb G_ma)
//                                  + lam c G_na G_mb
//   Poisson:    Ke[n, m]        += c G_n.G_m.
//
// What bounds it on the H100: hex8 elasticity writes 576 floats and
// reads 32 per element (2.4 KB): 638 MB at 65^3 (262,144 elements), 190
// us at 3.35 TB/s, and needs ~1.6e4 flops per element for the upper
// triangle (61 us at 67 TFLOP/s): bytes first.  The quadratic elements
// need more flops per output (brick20: 27 points) but are bytes-bound
// too when only the upper triangle is counted.
// What the design does about it: a block walks over groups of EPB
// elements (grid: as many blocks as the card holds at once) in phases
// separated by barriers, so the geometry is computed once per element
// and spread over many threads (the shape-derivative table sits in
// shared memory):
//   C1. per (element, point, row r): the centred coordinates' row r of
//       the Jacobian;
//   C2. per (element, point): its inverse and c = cq w detJ;
//   D.  per (element, point, node): the gradient G_n, stored as the
//       float4s G_n and c G_n;
//   E.  per (element, node pair n <= m) of the upper triangle: the outer
//       product A = sum_q (c G_n) G_m^T (9 FMAs a point from two float4
//       loads), then Ke[(n,a),(m,b)] = mu (A_ba + d_ab tr A) + lam A_ab,
//       written to the element's tile in shared memory at (n, m) and
//       mirrored to (m, n) (n == m: the block itself, no mirror), so
//       every output has one writer and a repeat call is bit-identical;
//   F.  the group's tiles, contiguous in Ke, stored as 16-byte vectors.
// The next group's inputs (element-minor rows of EPB consecutive
// floats) are loaded into registers while the current one computes.
// EPB keeps a block's static shared memory under 48 KB and its threads
// at 224-448, so an SM holds 2-4 blocks; a ragged last group is masked,
// nothing is padded.  hex8 and tet10 Poisson, whose Ke a thread can hold
// whole, take a thread per element instead (poisson_elem_kernel).
#include <cuda_runtime.h>

namespace {

template <int NN, int NQ, bool ELASTIC, int EPB>
struct Form {
  static constexpr int ND = ELASTIC ? 3 : 1;
  static constexpr int NDPE = ND * NN;
  static constexpr int KE = NDPE * NDPE;       // floats of one Ke
  static constexpr int PAIRS = NN * (NN + 1) / 2;
  static constexpr int TW = 3 * NN + 1;        // table row: dN, then w_q
  // a point's row of gradients, padded to an odd number of float4s, so
  // rows of the same node n fall into distinct banks
  static constexpr int NNP = NN | 1;
  static constexpr int THREADS = (EPB * PAIRS + 31) / 32 * 32;
  static constexpr int RAW = (3 * NN + NQ) * EPB;  // a group's inputs
  static constexpr int PF = (RAW + THREADS - 1) / THREADS;
  static_assert(KE % 4 == 0, "Ke tiles are stored as float4");
  static_assert(EPB * NQ <= THREADS, "phase C2: one (element, point) a "
                                     "thread");
};

template <int NN, int NQ, bool ELASTIC, int EPB>
__global__ void __launch_bounds__(Form<NN, NQ, ELASTIC, EPB>::THREADS)
stiffness_3d_kernel(const float* __restrict__ XeT,
                    const float* __restrict__ cq,
                    const float* __restrict__ tab, float mu, float lam,
                    int E, float* __restrict__ Ke) {
  using F = Form<NN, NQ, ELASTIC, EPB>;
  constexpr int ND = F::ND, NDPE = F::NDPE, KE = F::KE, TW = F::TW;
  constexpr int RAW = F::RAW, PF = F::PF, NNP = F::NNP;
  __shared__ float s_tab[NQ * TW];
  __shared__ float s_raw[RAW];                // rows (XeT, then cq) x EPB
  __shared__ float s_j[EPB][NQ][10];          // J, then its inverse and c
  __shared__ float4 s_g[EPB][NQ][NNP];        // G_n
  __shared__ float4 s_gc[EPB][NQ][NNP];       // c G_n
  __shared__ float4 s_k[EPB * KE / 4];        // the group's Ke tiles

  const int tid = threadIdx.x;
  const long long En = E;
  const int ngroups = static_cast<int>((En + EPB - 1) / EPB);
  for (int i = tid; i < NQ * TW; i += F::THREADS) s_tab[i] = tab[i];

  // a group's inputs, one float per thread and PF slot: row r, element le
  auto fetch = [&](int g, float (&v)[PF]) {
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      const int j = tid + u * F::THREADS;
      const int r = j / EPB, le = j % EPB;
      const long long e = static_cast<long long>(g) * EPB + le;
      v[u] = 0.f;
      if (g < ngroups && j < RAW && e < En)
        v[u] = r < 3 * NN ? __ldg(XeT + r * En + e)
                          : __ldg(cq + (r - 3 * NN) * En + e);
    }
  };
  float pf[PF];
  fetch(blockIdx.x, pf);

  for (int g = blockIdx.x; g < ngroups; g += gridDim.x) {
    const long long e0 = static_cast<long long>(g) * EPB;
    const int ne = static_cast<int>(En - e0 < EPB ? En - e0 : EPB);
#pragma unroll
    for (int u = 0; u < PF; ++u)
      if (tid + u * F::THREADS < RAW) s_raw[tid + u * F::THREADS] = pf[u];
    fetch(g + gridDim.x, pf);  // in flight while this group computes
    __syncthreads();

    // C1. per (element, point, row r): centroid-centred coordinate r of
    // the nodes, then row r of the Jacobian
    for (int t = tid; t < EPB * NQ * 3; t += F::THREADS) {
      const int r = t % 3, q = (t / 3) % NQ, le = t / (3 * NQ);
      const float* dn = s_tab + q * TW;
      const float* x = s_raw + r * EPB + le;  // x[3 n EPB]: node n
      float mean = 0.f;
#pragma unroll
      for (int n = 0; n < NN; ++n) mean += x[3 * n * EPB];
      mean *= 1.f / NN;
      float xr = x[0] - mean;
      float J[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) J[k] = dn[k] * xr;
#pragma unroll
      for (int n = 1; n < NN; ++n) {
        xr = x[3 * n * EPB] - mean;
#pragma unroll
        for (int k = 0; k < 3; ++k) J[k] += dn[3 * n + k] * xr;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) s_j[le][q][3 * r + k] = J[k];
    }
    __syncthreads();

    // C2. per (element, point): the inverse by cofactors, c = cq w detJ
    // (in place of J)
    if (tid < EPB * NQ) {
      const int q = tid % NQ, le = tid / NQ;
      float* j = s_j[le][q];
      float J[3][3];
#pragma unroll
      for (int i = 0; i < 9; ++i) J[i / 3][i % 3] = j[i];
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
      // invJ[m][l] = dxi_m / dx_l, row-major
      j[0] = c00 * inv_det; j[1] = c10 * inv_det; j[2] = c20 * inv_det;
      j[3] = c01 * inv_det; j[4] = c11 * inv_det; j[5] = c21 * inv_det;
      j[6] = c02 * inv_det; j[7] = c12 * inv_det; j[8] = c22 * inv_det;
      j[9] = s_raw[(3 * NN + q) * EPB + le] * (s_tab[q * TW + 3 * NN] * detJ);
    }
    __syncthreads();

    // D. per (element, point, node): G_n and c G_n
    for (int t = tid; t < EPB * NQ * NN; t += F::THREADS) {
      const int n = t % NN, q = (t / NN) % NQ, le = t / (NN * NQ);
      const float* dn = s_tab + q * TW + 3 * n;
      const float* ij = s_j[le][q];
      float G[3];
#pragma unroll
      for (int l = 0; l < 3; ++l)
        G[l] = dn[0] * ij[l] + dn[1] * ij[3 + l] + dn[2] * ij[6 + l];
      const float c = ij[9];
      s_g[le][q][n] = make_float4(G[0], G[1], G[2], 0.f);
      s_gc[le][q][n] = make_float4(c * G[0], c * G[1], c * G[2], 0.f);
    }
    __syncthreads();

    // E. per (element, node pair n <= m): the block of Ke
    if (tid < EPB * F::PAIRS) {
      const int le = tid / F::PAIRS;
      int m = tid % F::PAIRS, n = 0;
      while (m >= NN - n) {  // the pair's row n in the upper triangle
        m -= NN - n;
        ++n;
      }
      m += n;
      float A[ND * ND];  // sum_q (c G_n)_i (G_m)_j; Poisson: the trace
#pragma unroll
      for (int i = 0; i < ND * ND; ++i) A[i] = 0.f;
      constexpr int UNROLL = NQ <= 8 ? NQ : 3;  // brick20: 27 = 9 x 3
#pragma unroll(UNROLL)
      for (int q = 0; q < NQ; ++q) {
        const float4 a4 = s_gc[le][q][n], b4 = s_g[le][q][m];
        const float gc[3] = {a4.x, a4.y, a4.z};
        const float gm[3] = {b4.x, b4.y, b4.z};
        if constexpr (ELASTIC) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) A[i * 3 + j] += gc[i] * gm[j];
        } else {
          A[0] += gc[0] * gm[0] + gc[1] * gm[1] + gc[2] * gm[2];
        }
      }
      float* k = reinterpret_cast<float*>(s_k) + le * KE;
      float tr = 0.f;
      if constexpr (ELASTIC) tr = A[0] + A[4] + A[8];
#pragma unroll
      for (int a = 0; a < ND; ++a)
#pragma unroll
        for (int b = 0; b < ND; ++b) {
          float v = A[a * ND + b];
          if constexpr (ELASTIC)
            v = mu * (A[b * ND + a] + (a == b ? tr : 0.f)) + lam * v;
          const int r = n * ND + a, s = m * ND + b;
          k[r * NDPE + s] = v;
          if (n != m) k[s * NDPE + r] = v;
        }
    }
    __syncthreads();

    // F. the group's tiles are contiguous in Ke: 16-byte stores
    float4* out = reinterpret_cast<float4*>(Ke + e0 * KE);
    for (int i = tid; i < ne * (KE / 4); i += F::THREADS) out[i] = s_k[i];
  }
}

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

// dN[q][n][d] of elements.py::_hex8_shape (same operation order), as
// float: element_table's hex8 values
__host__ __device__ constexpr float hex8_dn(int q, int n, int d) {
  const int o0 = d == 0 ? 1 : 0, o1 = d == 2 ? 1 : 2;
  const double t0 = 1.0 + hex8_sign(n, o0) * hex8_pt(q, o0);
  const double t1 = 1.0 + hex8_sign(n, o1) * hex8_pt(q, o1);
  return static_cast<float>(0.125 * hex8_sign(n, d) * t0 * t1);
}

// Poisson on hex8 and tet10: Ke has 36 (55) distinct entries, few enough
// for one thread to hold them all, so a thread takes an element: its
// geometry once, in registers, every point unrolled (hex8's shape
// derivatives as immediates, tet10's from the table in shared memory),
// then a block of EPB elements writes its tiles through shared memory as
// contiguous lines (the group kernel above spends most of its phases on
// the geometry for these small Ke, with most of its threads idle).
template <int NN, int NQ, int EPB, bool HEX8>
__global__ void __launch_bounds__(EPB)
poisson_elem_kernel(const float* __restrict__ XeT,
                    const float* __restrict__ cq,
                    const float* __restrict__ tab, int E,
                    float* __restrict__ Ke) {
  constexpr int TW = 3 * NN + 1, KE = NN * NN, PAIRS = NN * (NN + 1) / 2;
  constexpr int KS = KE + 4;  // a tile's stride: rows of float4s
  static_assert(KE % 4 == 0, "Ke tiles are stored as float4");
  __shared__ float s_tab[HEX8 ? 1 : NQ * TW];
  __shared__ __align__(16) float s_k[EPB * KS];
  const int tid = threadIdx.x;
  const long long En = E;
  const long long e0 = static_cast<long long>(blockIdx.x) * EPB;
  const int ne = static_cast<int>(En - e0 < EPB ? En - e0 : EPB);
  const long long e = e0 + (tid < ne ? tid : 0);  // a ragged block's tail
                                                  // repeats element e0
  if constexpr (!HEX8)
    for (int i = tid; i < NQ * TW; i += EPB) s_tab[i] = tab[i];
  float c[NQ];  // cq, all loads in flight at once
#pragma unroll
  for (int q = 0; q < NQ; ++q) c[q] = __ldg(cq + q * En + e);
  float x[3][NN];  // centroid-centred coordinates
  if constexpr (!HEX8) __syncthreads();
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float mean = 0.f;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      x[r][n] = __ldg(XeT + (3 * n + r) * En + e);
      mean += x[r][n];
    }
    mean *= 1.f / NN;
#pragma unroll
    for (int n = 0; n < NN; ++n) x[r][n] -= mean;
  }

  float acc[PAIRS];  // the upper triangle, row-major
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) acc[p] = 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float* tq = s_tab + q * TW;
    // dN[q] component i = 3 n + k, then w_q
    auto dn = [&](int i) -> float {
      if constexpr (HEX8) return i < 3 * NN ? hex8_dn(q, i / 3, i % 3)
                                            : 1.f;  // hex8 weights are 1
      else return tq[i];
    };
    float J[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float t = dn(k) * x[r][0];
#pragma unroll
        for (int n = 1; n < NN; ++n) t += dn(3 * n + k) * x[r][n];
        J[r][k] = t;
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
    const float invJ[3][3] = {
        {c00 * inv_det, c10 * inv_det, c20 * inv_det},
        {c01 * inv_det, c11 * inv_det, c21 * inv_det},
        {c02 * inv_det, c12 * inv_det, c22 * inv_det}};
    const float cw = c[q] * (dn(3 * NN) * detJ);
    float G[NN][3];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        G[n][l] = dn(3 * n) * invJ[0][l] + dn(3 * n + 1) * invJ[1][l] +
                  dn(3 * n + 2) * invJ[2][l];
    int p = 0;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float gc[3] = {cw * G[n][0], cw * G[n][1], cw * G[n][2]};
#pragma unroll
      for (int m = n; m < NN; ++m, ++p)
        acc[p] += gc[0] * G[m][0] + gc[1] * G[m][1] + gc[2] * G[m][2];
    }
  }
  // the element's tile, the mirror from the upper triangle, then the
  // block's tiles, contiguous in Ke, as coalesced float4 stores (a
  // thread's own 16-byte stores would be 256 bytes apart across a warp)
  float* k = s_k + tid * KS;
  int p = 0;
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int m = n; m < NN; ++m, ++p) {
      k[n * NN + m] = acc[p];
      if (m != n) k[m * NN + n] = acc[p];
    }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(Ke + e0 * KE);
  const float4* t4 = reinterpret_cast<const float4*>(s_k);
  for (int i = tid; i < ne * (KE / 4); i += EPB)
    out[i] = t4[(i / (KE / 4)) * (KS / 4) + i % (KE / 4)];
}

// Blocks of one instance an SM holds (asked once per instance: every
// card the library is built for, sm_90a, has the same limits)
template <typename K>
int blocks_per_sm(K kern, int threads) {
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, threads, 0) !=
      cudaSuccess)
    return 1;
  return nb > 0 ? nb : 1;
}

template <int NN, int NQ, bool ELASTIC, int EPB>
int launch(const void* XeT, const void* cq, const void* tab, float mu,
           float lam, int E, void* Ke, cudaStream_t s) {
  using F = Form<NN, NQ, ELASTIC, EPB>;
  auto kern = stiffness_3d_kernel<NN, NQ, ELASTIC, EPB>;
  static const int occ = blocks_per_sm(kern, F::THREADS);
  int dev = 0, nsm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  const long long ngroups = (static_cast<long long>(E) + EPB - 1) / EPB;
  const long long cap = static_cast<long long>(occ) * (nsm > 0 ? nsm : 1);
  const int grid = static_cast<int>(ngroups < cap ? ngroups : cap);
  kern<<<grid, F::THREADS, 0, s>>>(
      static_cast<const float*>(XeT), static_cast<const float*>(cq),
      static_cast<const float*>(tab), mu, lam, E, static_cast<float*>(Ke));
  return static_cast<int>(cudaGetLastError());
}

template <int NN, int NQ, int EPB>
int launch_poisson_elem(const void* XeT, const void* cq, const void* tab,
                        int E, void* Ke, cudaStream_t s) {
  poisson_elem_kernel<NN, NQ, EPB, NN == 8>
      <<<(E + EPB - 1) / EPB, EPB, 0, s>>>(
      static_cast<const float*>(XeT), static_cast<const float*>(cq),
      static_cast<const float*>(tab), E, static_cast<float*>(Ke));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nn: 8 (hex8, 8 points), 10 (tet10, 5 points) or 20 (brick20, 27
// points); tab: the element's (nq, 3nn+1) float table of shape
// derivatives and weights (ops/element_kernels3d.py::element_table);
// Ke: (E, ndpe, ndpe) float, element-major.
extern "C" int pyfem_stiffness_3d(const void* XeT, const void* cq,
                                  const void* tab, float mu, float lam,
                                  int elastic, int nn, int E, void* Ke,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E <= 0 || tab == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nn == 8)
    return elastic ? launch<8, 8, true, 8>(XeT, cq, tab, mu, lam, E, Ke, s)
                   : launch_poisson_elem<8, 8, 128>(XeT, cq, tab, E, Ke, s);
  if (nn == 10)
    return elastic ? launch<10, 5, true, 8>(XeT, cq, tab, mu, lam, E, Ke, s)
                   : launch_poisson_elem<10, 5, 64>(XeT, cq, tab, E, Ke, s);
  if (nn == 20)
    return elastic ? launch<20, 27, true, 1>(XeT, cq, tab, mu, lam, E, Ke, s)
                   : launch<20, 27, false, 1>(XeT, cq, tab, mu, lam, E, Ke, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
