// K2: one damped-Jacobi step, residual or matvec on the BC-eliminated
// 9-point stencil in full or half-symmetric storage, on an NVIDIA Hopper
// card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_smooth.py:
//   fused_sweeps_2d (Pallas kernel _kernel, with sym_list=None and with
//   the sym_list body of half storage).  The TPU kernel runs all
// sweeps of a smoothing call plus the residual in one pass over the
// coefficients with ghost rows; this kernel does ONE step per launch and
// the wrapper (ops/fused_smooth.py::fused_sweeps_2d) launches it niter
// (+1) times, ping-ponging two buffers.  Plain reference:
// ops/fused_smooth.py::fused_sweeps_2d_plain.
//
// Per node, with A x = sum_{c2,dy,dx} coeff[(c*nd+c2)*9+dy*3+dx] *
// x[c2](iy+dy-1, ix+dx-1) (neighbours outside the grid read as 0) on full
// storage, and on half storage (the kept planes of
// ops/fused_smooth.py::sym_planes_2d, 19 of 36 at nd=2, 5 of 9 at nd=1)
//   (A x)[a](i) = sum over kept planes k = (a, b, d):
//                   coeff[k](i) * x[b](i + d - 1)
//               + sum over kept planes k = (c, a, d) not their own partner:
//                   coeff[k](i - (d - 1)) * x[c](i - (d - 1))
// -- the partner plane (a, c, 2 - d) is the stored one shifted:
// coeff[(b,a,2-dy,2-dx)](i) = coeff[(a,b,dy,dx)](i+d-1), read as 0 where
// i - (d - 1) lies outside the grid:
//   mode 0 (sweep):     out = x + omega * invd * (b - A x)
//   mode 1 (residual):  out = b - A x
//   mode 2 (-residual): out = A x - b
// b == nullptr reads as 0; x == nullptr reads as 0 and skips the
// stencil (the elementwise first sweep from x0 = 0).  Coefficients are
// f32 or bf16 (loaded as bf16, arithmetic in f32); fields are f32.
//
// What bounds it on the H100: bytes.  Per node it reads nd*nd*9
// coefficients (144 B f32 / 72 B bf16 at nd=2) and writes nd floats; the
// x neighbourhood and b/invd are ~24 B more, most x reuse hitting L1/L2.
// About 90 MB (f32) or 52 MB (bf16) per step at 1025x513, ~27 / 16 us at
// 3.35 TB/s; ~40 FMAs per node are nowhere near the compute roof.  Half
// storage reads 19 planes (76 B f32 / 38 B bf16 at nd=2): the f32 matvec
// moves ~48 MB, ~14 us; the partner reads hit the neighbours' lines in
// L1/L2.
// What the design does about it: one thread per node with x fastest, so
// each coefficient plane is streamed once with coalesced loads; the bf16
// copy halves the dominant coefficient bytes.  Fusing the sweeps into
// one coefficient pass (temporal blocking in shared memory) is the
// next step and is not done here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_coeff(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_coeff(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <int ND, bool FULL, typename CT>
__global__ void smooth_2d_kernel(const CT* __restrict__ coeff,
                                 const float* __restrict__ invd,
                                 const float* __restrict__ b,
                                 const float* __restrict__ x,
                                 float* __restrict__ out, int ny, int nx,
                                 float omega, int mode) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long node = (long long)iy * nx + ix;

  float ax[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) ax[c] = 0.f;
  if (x != nullptr) {
    float xv[ND][3][3];
#pragma unroll
    for (int c2 = 0; c2 < ND; ++c2) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int jy = iy + dy - 1;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int jx = ix + dx - 1;
          xv[c2][dy][dx] = (jy >= 0 && jy < ny && jx >= 0 && jx < nx)
                               ? __ldg(x + c2 * plane + (long long)jy * nx + jx)
                               : 0.f;
        }
      }
    }
    if constexpr (FULL) {
#pragma unroll
      for (int c = 0; c < ND; ++c) {
#pragma unroll
        for (int c2 = 0; c2 < ND; ++c2) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int k = (c * ND + c2) * 9 + dy * 3 + dx;
              ax[c] += load_coeff(coeff + k * plane + node) * xv[c2][dy][dx];
            }
          }
        }
      }
    } else {
      // partner node i - (d - 1) inside the grid, per offset index
      const bool vy[3] = {iy > 0, true, iy < ny - 1};
      const bool vx[3] = {ix > 0, true, ix < nx - 1};
      int si = 0;  // storage slot of the kept plane (constant once unrolled)
#pragma unroll
      for (int a = 0; a < ND; ++a) {
#pragma unroll
        for (int bb = 0; bb < ND; ++bb) {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int k = (a * ND + bb) * 9 + dy * 3 + dx;
              const int pk = (bb * ND + a) * 9 + (2 - dy) * 3 + (2 - dx);
              if (pk < k) continue;  // sym_planes_2d's rule
              const CT* cp = coeff + si * plane + node;
              ax[a] += load_coeff(cp) * xv[bb][dy][dx];
              if (pk != k && vy[2 - dy] && vx[2 - dx]) {
                // partner (bb, a, 2 - d) here: the kept value of node
                // i - (d - 1) times x[a] there
                ax[bb] += load_coeff(cp + (1 - dy) * nx + (1 - dx)) *
                          xv[a][2 - dy][2 - dx];
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
    const long long i = c * plane + node;
    const float bv = b != nullptr ? __ldg(b + i) : 0.f;
    const float r = bv - ax[c];
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
void launch_nd(const void* coeff, int coeff_bf16, const float* invd,
               const float* b, const float* x, float* out, int ny, int nx,
               float omega, int mode, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8);
  if (coeff_bf16) {
    smooth_2d_kernel<ND, FULL, __nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(coeff), invd, b, x, out, ny, nx,
        omega, mode);
  } else {
    smooth_2d_kernel<ND, FULL, float><<<grid, block, 0, s>>>(
        static_cast<const float*>(coeff), invd, b, x, out, ny, nx, omega,
        mode);
  }
}

template <bool FULL>
int launch(const void* coeff, int coeff_bf16, const void* invd,
           const void* b, const void* x, void* out, int nd, int ny, int nx,
           float omega, int mode, void* stream) {
  if (mode < 0 || mode > 2 || (mode == 0 && invd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (nd == 2) {
    launch_nd<2, FULL>(coeff, coeff_bf16, f(invd), f(b), f(x),
                       static_cast<float*>(out), ny, nx, omega, mode, s);
  } else if (nd == 1) {
    launch_nd<1, FULL>(coeff, coeff_bf16, f(invd), f(b), f(x),
                       static_cast<float*>(out), ny, nx, omega, mode, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All nd*nd*9 planes (K2 full storage).
extern "C" int pyfem_smooth_2d(const void* coeff, int coeff_bf16,
                               const void* invd, const void* b,
                               const void* x, void* out, int nd, int ny,
                               int nx, float omega, int mode, void* stream) {
  return launch<true>(coeff, coeff_bf16, invd, b, x, out, nd, ny, nx, omega,
                      mode, stream);
}

// The kept planes of sym_planes_2d (K2 half-symmetric storage).
extern "C" int pyfem_smooth_2d_sym(const void* coeff, int coeff_bf16,
                                   const void* invd, const void* b,
                                   const void* x, void* out, int nd, int ny,
                                   int nx, float omega, int mode,
                                   void* stream) {
  return launch<false>(coeff, coeff_bf16, invd, b, x, out, nd, ny, nx,
                       omega, mode, stream);
}
