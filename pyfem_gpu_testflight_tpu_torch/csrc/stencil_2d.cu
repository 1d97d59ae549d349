// K9: y = A u for a 9-point, nd-component stencil operator on unpacked
// coefficient planes, with zero padding, on an NVIDIA Hopper card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_stencil.py:
//   stencil_matvec_2d (Pallas kernel _kernel).
// Plain reference: ops/stencil_matvec.py::stencil_matvec_2d_plain (the
// shifted-slice body of Stencil2D.matvec).
//
// Per node (iy, ix) and component c:
//   y[c](iy, ix) = sum_{c2, dy, dx} coeff[c, c2, dy, dx](iy, ix)
//                                   * u[c2](iy + dy - 1, ix + dx - 1)
// with u read as 0 outside the grid.  coeff (nd, nd, 3, 3, ny, nx), u and
// y (nd, ny, nx), all in one type T (float or double).
//
// What bounds it on the H100: bytes.  Per node it reads nd*nd*9
// coefficients and nd values of u and writes nd values: 44 B at nd=1 in
// f32, 160 B at nd=2 in f32, 320 B at nd=2 in f64 -- about 23, 84 and 168
// MB at 1025x513 (7, 25 and 50 us at 3.35 TB/s).  2*nd*nd*9 flops per
// node are far below the compute roof, in f64 too (67 TFLOP/s).
// What the design does about it: one thread per node, x fastest, so each
// coefficient plane is streamed once with coalesced loads; the 3x3
// neighbourhood of u is read through the read-only cache, where the
// neighbouring threads' reads of the same rows hit.  Every output is
// written once; no atomics, so the result does not depend on the run.
#include <cuda_runtime.h>

namespace {

template <int ND, typename T>
__global__ void stencil_2d_kernel(const T* __restrict__ coeff,
                                  const T* __restrict__ u,
                                  T* __restrict__ out, int ny, int nx) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long node = (long long)iy * nx + ix;

  T uv[ND][3][3];
#pragma unroll
  for (int c2 = 0; c2 < ND; ++c2) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int jy = iy + dy - 1;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int jx = ix + dx - 1;
        uv[c2][dy][dx] = (jy >= 0 && jy < ny && jx >= 0 && jx < nx)
                             ? __ldg(u + c2 * plane + (long long)jy * nx + jx)
                             : T(0);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    T acc = T(0);
#pragma unroll
    for (int c2 = 0; c2 < ND; ++c2) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int k = (c * ND + c2) * 9 + dy * 3 + dx;
          acc += __ldg(coeff + k * plane + node) * uv[c2][dy][dx];
        }
      }
    }
    out[c * plane + node] = acc;
  }
}

template <typename T>
int launch(const void* coeff, const void* u, void* out, int nd, int ny,
           int nx, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8);
  auto c = static_cast<const T*>(coeff);
  auto x = static_cast<const T*>(u);
  auto y = static_cast<T*>(out);
  if (nd == 1) {
    stencil_2d_kernel<1, T><<<grid, block, 0, s>>>(c, x, y, ny, nx);
  } else if (nd == 2) {
    stencil_2d_kernel<2, T><<<grid, block, 0, s>>>(c, x, y, ny, nx);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f64 = 0: float32 coefficients and fields; f64 = 1: float64.
extern "C" int pyfem_stencil_2d(const void* coeff, const void* u, void* out,
                                int nd, int ny, int nx, int f64,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch<double>(coeff, u, out, nd, ny, nx, s)
             : launch<float>(coeff, u, out, nd, ny, nx, s);
}
