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
// elementwise first sweep from x0 = 0).  Coefficients are f32 or bf16
// (loaded as bf16, arithmetic in f32); fields are f32.
//
// K4 (pyfem_sweep_3d) is one pass.  K5 (pyfem_sweeps_3d) is the simple
// per-sweep form: it launches one pass per sweep into two ping-pong
// buffers and one for the residual.  The TPU kernel ran them all in one
// coefficient pass with z ghost planes; the single-pass z-blocked form is
// later work (ROADMAP.md).
//
// What bounds it on the H100: bytes.  A pass reads the 123 kept planes
// once (492 B per node in f32, 246 B in bf16) and ~36 B of fields, and
// writes 12 B (nd=3): ~142 MB for the f32 matvec at 65^3, ~42 us at
// 3.35 TB/s; ~250 FMAs per node are far below the compute roof.  Full
// storage reads 243 planes (972 B per node in f32): ~280 MB, ~84 us at
// 3.35 TB/s.
// What the design does about it: one thread per node, x fastest, so each
// plane is streamed with coalesced loads; a plane's partner read (the
// same plane at most one node away in each axis) is served by L1/L2 from
// the direct reads of the neighbouring threads, so device memory sees
// each coefficient about once per pass.  The bf16 copy halves the
// dominant coefficient bytes of the smoother passes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_coeff(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_coeff(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int ND, bool FULL, typename CT>
__global__ void sweep_3d_kernel(const CT* __restrict__ coeff,
                                const float* __restrict__ invd,
                                const float* __restrict__ b,
                                const float* __restrict__ x,
                                float* __restrict__ out, int nz, int ny,
                                int nx, float omega, int mode) {
  const int n = nz * ny * nx;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int ix = node % nx;
  const int iy = (node / nx) % ny;
  const int iz = node / (nx * ny);
  const long long plane = n;
  const int sz = ny * nx;

  float ax[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) ax[c] = 0.f;
  if (x != nullptr) {
    // neighbour offset -1 / 0 / +1 inside the grid, per axis
    const bool vz[3] = {iz > 0, true, iz < nz - 1};
    const bool vy[3] = {iy > 0, true, iy < ny - 1};
    const bool vx[3] = {ix > 0, true, ix < nx - 1};
    float xv[ND][27];
#pragma unroll
    for (int c = 0; c < ND; ++c) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            xv[c][dz * 9 + dy * 3 + dx] =
                (vz[dz] && vy[dy] && vx[dx])
                    ? __ldg(x + c * plane + node + (dz - 1) * sz +
                            (dy - 1) * nx + (dx - 1))
                    : 0.f;
          }
        }
      }
    }
    if constexpr (FULL) {
#pragma unroll
      for (int a = 0; a < ND; ++a) {
#pragma unroll
        for (int bb = 0; bb < ND; ++bb) {
#pragma unroll
          for (int d = 0; d < 27; ++d) {
            const long long k = (a * ND + bb) * 27 + d;
            ax[a] += load_coeff(coeff + k * plane + node) * xv[bb][d];
          }
        }
      }
    } else {
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
                const CT* cp = coeff + si * plane + node;
                ax[a] += load_coeff(cp) * xv[bb][dz * 9 + dy * 3 + dx];
                if (!self_pair && vz[2 - dz] && vy[2 - dy] && vx[2 - dx]) {
                  // partner (bb, a, 2 - d) at this node: the kept value of
                  // node i - (d - 1) times x[a] there
                  ax[bb] += load_coeff(cp + (1 - dz) * sz + (1 - dy) * nx +
                                       (1 - dx)) *
                            xv[a][(2 - dz) * 9 + (2 - dy) * 3 + (2 - dx)];
                }
                ++si;
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const long long i = c * plane + node;
    const float r = (b != nullptr ? __ldg(b + i) : 0.f) - ax[c];
    if (mode == 0) {
      const float xc = x != nullptr ? __ldg(x + i) : 0.f;
      out[i] = xc + omega * __ldg(invd + i) * r;
    } else if (mode == 1) {
      out[i] = r;
    } else {
      out[i] = -r;
    }
  }
}

template <int ND, bool FULL>
void launch_storage(const void* coeff, int coeff_bf16, const float* invd,
                    const float* b, const float* x, float* out, int nz,
                    int ny, int nx, float omega, int mode, cudaStream_t s) {
  const int n = nz * ny * nx;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (coeff_bf16) {
    sweep_3d_kernel<ND, FULL, __nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(coeff), invd, b, x, out, nz, ny,
        nx, omega, mode);
  } else {
    sweep_3d_kernel<ND, FULL, float><<<grid, block, 0, s>>>(
        static_cast<const float*>(coeff), invd, b, x, out, nz, ny, nx,
        omega, mode);
  }
}

template <int ND>
void launch_nd(const void* coeff, int coeff_bf16, int full, const float* invd,
               const float* b, const float* x, float* out, int nz, int ny,
               int nx, float omega, int mode, cudaStream_t s) {
  if (full) {
    launch_storage<ND, true>(coeff, coeff_bf16, invd, b, x, out, nz, ny, nx,
                             omega, mode, s);
  } else {
    launch_storage<ND, false>(coeff, coeff_bf16, invd, b, x, out, nz, ny, nx,
                              omega, mode, s);
  }
}

// One stencil pass; returns cudaGetLastError() of its launch.  full = 1:
// all nd*nd*27 planes; full = 0: the kept planes of sym_planes_3d.
int pass(const void* coeff, int coeff_bf16, int full, const void* invd,
         const void* b, const void* x, void* out, int nd, int nz, int ny,
         int nx, float omega, int mode, cudaStream_t s) {
  if (mode < 0 || mode > 2 || (mode == 0 && invd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (nd == 3) {
    launch_nd<3>(coeff, coeff_bf16, full, f(invd), f(b), f(x),
                 static_cast<float*>(out), nz, ny, nx, omega, mode, s);
  } else if (nd == 1) {
    launch_nd<1>(coeff, coeff_bf16, full, f(invd), f(b), f(x),
                 static_cast<float*>(out), nz, ny, nx, omega, mode, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
