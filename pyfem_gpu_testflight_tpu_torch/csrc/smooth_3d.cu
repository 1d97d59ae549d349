// K4 and K5: damped-Jacobi sweeps, residual and matvec on the
// BC-eliminated 27-point stencil in half-symmetric or full storage, on an
// NVIDIA Hopper card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_smooth.py:
//   K4  fused_sweep_3d, Pallas kernels _kernel3d_sym (half storage) and
//       _kernel3d (full storage), one operation per call;
//   K5  fused_sweeps3d, Pallas kernel _kernel3d_multi, all sweeps of one
//       smoothing call (+ the residual).
// Plain references: ops/fused_smooth.py::fused_sweep_3d_plain and
// fused_sweeps3d_plain.
//
// One stencil pass (sweep_3d_kernel), per node i and component a; on full
// storage (all nd*nd*27 planes, k = (a*nd + b)*27 + d):
//   (A x)[a](i) = sum over planes k = (a, b, d): coeff[k](i) * x[b](i + d - 1)
// and on half storage:
//   (A x)[a](i) = sum over kept planes k = (a, b, d):
//                   coeff[k](i) * x[b](i + d - 1)
//               + sum over kept planes k = (c, a, d) not their own partner:
//                   coeff[k](i - (d - 1)) * x[c](i - (d - 1))
// (the second sum is the partner plane (a, c, 2 - d), rebuilt from the
// neighbour's stored coefficient); off-grid neighbours read as 0.
//   mode 0 (sweep):     out = x + omega * invd * (b - A x)
//   mode 1 (residual):  out = b - A x
//   mode 2 (-residual): out = A x - b
// b == nullptr reads as 0 (so modes 1/2 with b == nullptr are -A x / A x,
// the matvec); x == nullptr reads as 0 and skips the stencil (the
// elementwise first sweep from x0 = 0, first_sweep_3d_kernel).
// Coefficients are f32 or bf16 (loaded as bf16, arithmetic in f32); fields
// are f32.
//
// K4 (pyfem_sweep_3d) is one pass.  K5 (pyfem_sweeps_3d) launches one pass
// per sweep into two ping-pong buffers and one for the residual (a single
// cooperative launch per call was tried and tied: PERF.md section 6).
//
// What bounds it on the H100.  The bytes would: a pass reads the 123 kept
// planes once (492 B per node in f32, 246 B in bf16) and ~36 B of fields
// and writes 12 B (nd=3): 142 MB for the f32 matvec at 65^3, 42 us at
// 3.35 TB/s, 20 us for the bf16 sweep; full storage reads 243 planes.
// ~250 FMAs per node are far below the compute roof.  But the earlier
// body (one thread per node, 81 predicated x loads and ~240 coefficient
// loads held against an x[nd][27] register array) took the same device
// time on f32 and on bf16 planes (0.115 / 0.111 ms for a sweep at 65^3
// on an H100), and its full-storage pass, twice the bytes at the same count of
// loads, 2.3x as long: the loads a thread has in flight, not the bytes,
// set the pace (PERF.md section 6; ncu does not run on the card).
// What this design does about it: a block of 128 threads owns 128
// consecutive nodes of one xy plane z (a node each).  It stages x of the
// planes z - 1, z and z + 1 on the chunk plus a one-node halo in shared
// memory with cp.async, all in flight at once, zero off the grid, so a
// thread issues no x loads and holds no x registers.  What is left per
// node is its coefficient loads (and the partner loads of half storage),
// with nothing between them but FMAs and no branch (an off-grid partner's
// load is pointed at the node's own value, times x = 0), so the compiler
// can keep many of them in flight; the register budget a thread gets is
// set per coefficient type (MinBlocks): enough for the loads, and enough
// warps per SM.  On f32 half-storage planes at nd = 3 a level whose pass
// needs more than one wave of the uncapped body (2 blocks an SM) but one
// of the body cut to 168 registers (3 blocks) takes the latter
// (launch_body): 33^3 on an H100.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int CH = 128;  // threads of a block: consecutive nodes of a plane

// Blocks per SM the register budget is cut for: 3 (at most 168 registers
// a thread) on bf16 planes; none on f32 planes, whose loads take twice the
// registers.  Each the fastest at 65^3 of the caps 1-4 measured (PERF.md
// section 6).  On f32 half-storage planes at nd = 3 a second instance cut for
// 3 blocks serves the levels where it saves a wave (launch_body).
template <typename CT>
struct MinBlocks {
  static constexpr int value = 1;
};
template <>
struct MinBlocks<__nv_bfloat16> {
  static constexpr int value = 3;
};

// Dynamic shared memory a block may use on the H100 (227 KiB): the x
// window of sweep_3d_kernel, 12 * ND * pitch bytes with pitch ~ 2 nx +
// 137, fits it up to nx = 3159 at nd = 3 and nx = 9615 at nd = 1; a
// wider grid is refused (ops/fused_smooth.py::sweep3d_smem checks this
// before a launch).
constexpr int kSmemMax = 227 * 1024;

__device__ __forceinline__ float load_coeff(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_coeff(const __nv_bfloat16* p) {
  const unsigned short u =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// One stencil pass.  A block of CH threads owns a chunk of CH consecutive
// nodes of one xy plane z, a node each.  It stages x of the planes z - 1,
// z and z + 1 on the chunk with a one-node halo in shared memory: the
// window of the plane's rows padded to pitch P = nx + 2 with a zero column
// each side and a zero row above and below, where node (iy, ix) sits at
// padded index (iy + 1) * P + ix + 1 = lin + 2 iy + P + 1, starting one
// padded row and one column before the chunk's first node; off-grid
// planes read 0.  Then each thread loads its node's coefficients (and,
// in half storage, each partner value one node over in plane z or z + 1)
// with nothing between the loads but FMAs.
template <int ND, bool FULL, typename CT, int MB = MinBlocks<CT>::value>
__global__ void __launch_bounds__(CH, MB)
    sweep_3d_kernel(const CT* __restrict__ coeff,
                    const float* __restrict__ invd,
                    const float* __restrict__ b, const float* __restrict__ x,
                    float* __restrict__ out, int nz, int ny, int nx,
                    int pitch, float omega, int mode) {
  extern __shared__ __align__(16) float s_x[];  // [3 planes][ND][pitch]
  const int sz = ny * nx;
  const long long n = static_cast<long long>(nz) * sz;
  const int c0 = blockIdx.x * CH;
  const int z = blockIdx.y;
  const int p = nx + 2;
  const int iy0 = c0 / nx;
  const int ws = c0 + 2 * iy0;  // padded index of the window's first entry
  const int last = min(c0 + CH, sz) - 1;
  const int wl = last - c0 + 2 * (last / nx - iy0) + 2 * p + 3;
  for (int i = threadIdx.x; i < wl; i += CH) {
    const int q = ws + i;
    const int iy = q / p - 1, ix = q - (q / p) * p - 1;
    const bool in = iy >= 0 && iy < ny && ix >= 0 && ix < nx;
#pragma unroll
    for (int dz = 0; dz < 3; ++dz) {
      const int zz = z + dz - 1;
      const bool zin = in && zz >= 0 && zz < nz;
      const long long g = static_cast<long long>(zz) * sz +
                          static_cast<long long>(iy) * nx + ix;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        float* d = s_x + (dz * ND + c) * pitch + i;
        if (zin) {
          cp_async4(d, x + c * n + g);  // all in flight at once
        } else {
          *d = 0.f;
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int lin = c0 + threadIdx.x;
  if (lin >= sz) return;
  const int iy = lin / nx, ix = lin - (lin / nx) * nx;
  const int wi = threadIdx.x + 2 * (iy - iy0) + p + 1;  // node's window entry
  // x[c] at node (z + dz - 1, iy + oy, ix + ox)
  auto X = [&](int dz, int c, int oy, int ox) {
    return s_x[(dz * ND + c) * pitch + wi + oy * p + ox];
  };
  float ax[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) ax[c] = 0.f;
  const CT* cz = coeff + static_cast<long long>(z) * sz + lin;
  if constexpr (FULL) {
#pragma unroll
    for (int a = 0; a < ND; ++a)
#pragma unroll
      for (int bb = 0; bb < ND; ++bb)
#pragma unroll
        for (int d = 0; d < 27; ++d) {
          const int k = (a * ND + bb) * 27 + d;
          ax[a] += load_coeff(cz + k * n) *
                   X(d / 9, bb, (d / 3) % 3 - 1, d % 3 - 1);
        }
  } else {
    // the source node (iy - oy, ix - ox) of a partner term is on the
    // grid: bit (oy + 1) * 3 + ox + 1
    int src_ok = 0;
#pragma unroll
    for (int oy = -1; oy <= 1; ++oy)
#pragma unroll
      for (int ox = -1; ox <= 1; ++ox)
        if (iy - oy >= 0 && iy - oy < ny && ix - ox >= 0 && ix - ox < nx)
          src_ok |= 1 << ((oy + 1) * 3 + ox + 1);
    const bool up = z + 1 < nz;  // plane z + 1 is on the grid
    int si = 0;  // storage slot of the kept plane (constant once unrolled)
#pragma unroll
    for (int a = 0; a < ND; ++a) {
#pragma unroll
      for (int bb = 0; bb < ND; ++bb) {
#pragma unroll
        for (int dz = 0; dz < 2; ++dz) {  // dz = 2 planes are not stored
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              bool self_pair = false;
              if (dz == 1) {  // sym_planes_3d's rule for the dz = 1 half
                const int k2 = (a * ND + bb) * 9 + dy * 3 + dx;
                const int p2 = (bb * ND + a) * 9 + (2 - dy) * 3 + (2 - dx);
                if (p2 < k2) continue;
                self_pair = p2 == k2;
              }
              const int oy = dy - 1, ox = dx - 1;
              const CT* cp = cz + si * n;
              ax[a] += load_coeff(cp) * X(dz, bb, oy, ox);
              if (!self_pair) {
                // partner (bb, a, 2 - d) at this node: the kept value of
                // node i - (d - 1), in plane z + 1 - dz, times x[a] there.
                // Off the grid x reads 0 and the load is pointed at this
                // node's own value: no branch, so all the loads of a node
                // can be in flight together.
                const bool ok = ((src_ok >> ((oy + 1) * 3 + ox + 1)) & 1) &&
                                (dz == 1 || up);
                const int off = ok ? (dz == 0 ? sz : 0) - oy * nx - ox : 0;
                ax[bb] += load_coeff(cp + off) * X(2 - dz, a, -oy, -ox);
              }
              ++si;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const long long i = c * n + static_cast<long long>(z) * sz + lin;
    const float r = (b != nullptr ? __ldg(b + i) : 0.f) - ax[c];
    if (mode == 0) {
      out[i] = X(1, c, 0, 0) + omega * __ldg(invd + i) * r;
    } else if (mode == 1) {
      out[i] = r;
    } else {
      out[i] = -r;
    }
  }
}

// The elementwise first sweep from x0 = 0 (and, with x == nullptr, the
// residual modes): out = omega * invd * b, b, or -b.
__global__ void first_sweep_3d_kernel(const float* __restrict__ invd,
                                      const float* __restrict__ b,
                                      float* __restrict__ out, long long m,
                                      float omega, int mode) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= m) return;
  const float r = b != nullptr ? __ldg(b + i) : 0.f;
  out[i] = mode == 0 ? omega * __ldg(invd + i) * r : mode == 1 ? r : -r;
}

// Blocks of kern an SM holds at its register budget (the x window does not
// limit the small grids this is asked for; every card the library is
// built for, sm_90a, has the same register file, so it is asked once).
template <typename K>
int blocks_per_sm(K kern) {
  int nb = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, kern, CH, 0) !=
      cudaSuccess)
    return 0;
  return nb;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <int ND, bool FULL, typename CT, int MB>
int launch_kern(const void* coeff, const float* invd, const float* b,
                const float* x, float* out, int nz, int ny, int nx,
                int pitch, size_t smem, dim3 grid, float omega, int mode,
                cudaStream_t s) {
  auto kern = sweep_3d_kernel<ND, FULL, CT, MB>;
  if (smem > 48 * 1024) {
    // the limit is raised past the default 48 KiB once per card and size
    // the window grows to, not on every launch
    static int raised[16] = {};
    int dev = 0;
    cudaGetDevice(&dev);
    const int want = static_cast<int>(smem);
    if (dev < 0 || dev >= 16 || want > raised[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, want);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev >= 0 && dev < 16) raised[dev] = want;
    }
  }
  kern<<<grid, CH, smem, s>>>(static_cast<const CT*>(coeff), invd, b, x, out,
                              nz, ny, nx, pitch, omega, mode);
  return static_cast<int>(cudaGetLastError());
}

template <int ND, bool FULL, typename CT>
int launch_body(const void* coeff, const float* invd, const float* b,
                const float* x, float* out, int nz, int ny, int nx,
                float omega, int mode, cudaStream_t s) {
  // the longest x window of any block, padded to 4 entries
  const int wl = CH + 2 * ((CH + nx - 2) / nx) + 2 * (nx + 2) + 3;
  const int pitch = (wl + 3) / 4 * 4;
  const size_t smem = sizeof(float) * 3 * ND * pitch;
  if (smem > static_cast<size_t>(kSmemMax))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ny * nx + CH - 1) / CH, nz);
  if constexpr (ND == 3 && !FULL && std::is_same<CT, float>::value) {
    // f32 half storage at nd = 3: the uncapped instance (2 blocks an SM at
    // ~250 registers) unless the pass needs more than one wave of it and
    // one wave of the instance cut to 168 registers (3 blocks) holds it.
    // On an H100 that is the level size 264 < nz * ceil(ny nx / 128) <=
    // 396, i.e. 33^3 (297 blocks) of bench 3D's levels; on the others the
    // uncapped instance is the faster (PERF.md section 6).
    static const int occ1 =
        blocks_per_sm(sweep_3d_kernel<3, false, float, 1>);
    static const int occ3 =
        blocks_per_sm(sweep_3d_kernel<3, false, float, 3>);
    const long long nb = static_cast<long long>(grid.x) * grid.y;
    if (nb > static_cast<long long>(occ1) * sm_count() &&
        nb <= static_cast<long long>(occ3) * sm_count())
      return launch_kern<3, false, float, 3>(coeff, invd, b, x, out, nz, ny,
                                             nx, pitch, smem, grid, omega,
                                             mode, s);
  }
  return launch_kern<ND, FULL, CT, MinBlocks<CT>::value>(
      coeff, invd, b, x, out, nz, ny, nx, pitch, smem, grid, omega, mode, s);
}

template <int ND>
int launch_nd(const void* coeff, int coeff_bf16, int full, const float* invd,
              const float* b, const float* x, float* out, int nz, int ny,
              int nx, float omega, int mode, cudaStream_t s) {
  auto f = full ? (coeff_bf16 ? launch_body<ND, true, __nv_bfloat16>
                              : launch_body<ND, true, float>)
                : (coeff_bf16 ? launch_body<ND, false, __nv_bfloat16>
                              : launch_body<ND, false, float>);
  return f(coeff, invd, b, x, out, nz, ny, nx, omega, mode, s);
}

// One stencil pass; returns cudaGetLastError() of its launch.  full = 1:
// all nd*nd*27 planes; full = 0: the kept planes of sym_planes_3d.
int pass(const void* coeff, int coeff_bf16, int full, const void* invd,
         const void* b, const void* x, void* out, int nd, int nz, int ny,
         int nx, float omega, int mode, cudaStream_t s) {
  if (mode < 0 || mode > 2 || (mode == 0 && invd == nullptr) ||
      (nd != 1 && nd != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* o = static_cast<float*>(out);
  if (x == nullptr) {
    const long long m = static_cast<long long>(nd) * nz * ny * nx;
    first_sweep_3d_kernel<<<static_cast<unsigned>((m + 255) / 256), 256, 0,
                            s>>>(f(invd), f(b), o, m, omega, mode);
    return static_cast<int>(cudaGetLastError());
  }
  if (nd == 3)
    return launch_nd<3>(coeff, coeff_bf16, full, f(invd), f(b), f(x), o, nz,
                        ny, nx, omega, mode, s);
  return launch_nd<1>(coeff, coeff_bf16, full, f(invd), f(b), f(x), o, nz,
                      ny, nx, omega, mode, s);
}

}  // namespace

// K4: one sweep (mode 0), residual (1), negated residual (2).
extern "C" int pyfem_sweep_3d(const void* coeff, int coeff_bf16, int full,
                              const void* invd, const void* b, const void* x,
                              void* out, int nd, int nz, int ny, int nx,
                              float omega, int mode, void* stream) {
  return pass(coeff, coeff_bf16, full, invd, b, x, out, nd, nz, ny, nx,
              omega, mode, static_cast<cudaStream_t>(stream));
}

// K5: niter sweeps from x0 (nullptr = 0) with per-sweep damping
// omegas[0..niter) (host memory), alternating buf0 / buf1 (the result is
// in buf0 for odd niter, buf1 for even; buf1 may equal buf0 when
// niter == 1), then the residual into r with rmode 1 or 2 (rmode -1: no
// residual, r unused).
extern "C" int pyfem_sweeps_3d(const void* coeff, int coeff_bf16, int full,
                               const void* invd, const void* b,
                               const void* x0, void* buf0, void* buf1,
                               void* r, const float* omegas, int niter,
                               int rmode, int nd, int nz, int ny, int nx,
                               void* stream) {
  if (niter < 1 || b == nullptr || invd == nullptr ||
      (rmode != -1 && rmode != 1 && rmode != 2) ||
      (rmode != -1 && r == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* x = x0;
  for (int i = 0; i < niter; ++i) {
    void* out = (i % 2 == 0) ? buf0 : buf1;
    const int err = pass(coeff, coeff_bf16, full, invd, b, x, out, nd, nz,
                         ny, nx, omegas[i], 0, s);
    if (err != 0) return err;
    x = out;
  }
  if (rmode != -1)
    return pass(coeff, coeff_bf16, full, invd, b, x, r, nd, nz, ny, nx, 0.f,
                rmode, s);
  return 0;
}
