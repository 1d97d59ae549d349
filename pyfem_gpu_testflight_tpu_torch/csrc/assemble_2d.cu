// K1: nodal density -> BC-eliminated 9-point stencil planes + inverse
// diagonal (+ optional bf16 copy), one pass, on an NVIDIA Hopper card, in
// full storage (all nd*nd*9 planes) or half-symmetric storage (the kept
// planes of ops/fused_smooth.py::sym_planes_2d: 19 of 36 at nd=2, 5 of 9
// at nd=1).
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_assemble.py:
//   assemble_pack_2d with sym=False and sym=True (Pallas kernel _kernel).
// Plain reference: ops/fused_assemble.py::assemble_pack_2d_plain.
//
// Per node (iy, ix), for the <= 4 valid elements (ey, ex) = (iy-ay, ix-ax)
// that touch it:  Cq[ay,ax][q] = RAMP(sum_n N[q,n] rho[node n of elem])
// (phantom elements past the grid edge contribute 0), then for every
// plane k = (ca, cb, dy, dx)
//   coeff[k] = rowm[ca] * colm[cb](iy+dy-1, ix+dx-1)
//              * sum_{ay,ax,q} W[k, ay*2+ax, q] * Cq[ay,ax][q]
// with a unit diagonal at fixed dofs (symmetric Dirichlet elimination),
// and invd[c] = rowm[c] / diag[c]  (0 at fixed dofs).
//
// What bounds it on the H100: output bytes.  It reads the density and
// the free mask (3 floats per node at nd=2, mostly L2 hits for the 3x3
// neighbourhood) and writes 36 f32 planes + 36 bf16 planes + 2 inverse
// diagonal planes: 36 x 6 B + 8 B = 224 B per node, about 118 MB at
// 1025x513 (~35 us at 3.35 TB/s).  The ~600 FMAs per node are far below
// the card's compute roof.  Half storage writes 19 + 19 planes + 2: about
// 70 MB at nd=2 with the bf16 copy (~21 us).
// What the design does about it: one thread per node with x fastest, so
// each plane's store is one coalesced 128-byte line per warp; every
// output is written exactly once and nothing intermediate touches
// device memory.  W (nk x 4 x 4) and N (4 x 4) are tiny and read
// through the read-only cache with every lane of a warp on the same
// address (broadcast).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NQ = 4;  // quad4 2x2 Gauss points

template <int ND, bool FULL>
__global__ void assemble_2d_kernel(
    const float* __restrict__ rho, const float* __restrict__ maskf,
    const float* __restrict__ W, const float* __restrict__ N, float p,
    int ny, int nx, float* __restrict__ coeff, float* __restrict__ invd,
    __nv_bfloat16* __restrict__ coeff_lp) {
  const int ix = blockIdx.x * blockDim.x + threadIdx.x;
  const int iy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ix >= nx || iy >= ny) return;
  const long long plane = (long long)ny * nx;
  const long long node = (long long)iy * nx + ix;

  // RAMP material at the quad points of the 4 elements around the node
  float cq[4][NQ];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int ey = iy - (a >> 1), ex = ix - (a & 1);
#pragma unroll
    for (int q = 0; q < NQ; ++q) cq[a][q] = 0.f;
    if (ey >= 0 && ey < ny - 1 && ex >= 0 && ex < nx - 1) {
      const long long e0 = (long long)ey * nx + ex;
      // local node order (0,0), (0,1), (1,1), (1,0) as (dy, dx)
      const float r0 = __ldg(rho + e0), r1 = __ldg(rho + e0 + 1);
      const float r2 = __ldg(rho + e0 + nx + 1), r3 = __ldg(rho + e0 + nx);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const float s = __ldg(N + q * 4 + 0) * r0 + __ldg(N + q * 4 + 1) * r1
                      + __ldg(N + q * 4 + 2) * r2 + __ldg(N + q * 4 + 3) * r3;
        cq[a][q] = s / (1.f + p * (1.f - s));
      }
    }
  }

  float rowm[ND], diag[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    rowm[c] = __ldg(maskf + c * plane + node);
    diag[c] = 1.f;
  }

  int si = 0;  // storage slot of the plane (constant once unrolled)
#pragma unroll
  for (int ca = 0; ca < ND; ++ca) {
#pragma unroll
    for (int cb = 0; cb < ND; ++cb) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int jy = iy + dy - 1;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int jx = ix + dx - 1;
          const int k = (ca * ND + cb) * 9 + dy * 3 + dx;
          // sym_planes_2d: keep a plane unless its partner (cb, ca, 2-dy,
          // 2-dx) comes first in the full order
          if (!FULL && (cb * ND + ca) * 9 + (2 - dy) * 3 + (2 - dx) < k)
            continue;
          const float* w = W + k * 4 * NQ;
          float acc = 0.f;
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int q = 0; q < NQ; ++q) acc += __ldg(w + a * NQ + q) * cq[a][q];
          }
          const float colm = (jy >= 0 && jy < ny && jx >= 0 && jx < nx)
                                 ? __ldg(maskf + cb * plane + (long long)jy * nx + jx)
                                 : 0.f;
          float v = acc * rowm[ca] * colm;
          if (ca == cb && dy == 1 && dx == 1) {
            v += 1.f - rowm[ca];
            diag[ca] = v;
          }
          coeff[si * plane + node] = v;
          if (coeff_lp != nullptr) coeff_lp[si * plane + node] = __float2bfloat16_rn(v);
          ++si;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c)
    invd[c * plane + node] = rowm[c] / (diag[c] == 0.f ? 1.f : diag[c]);
}

template <bool FULL>
int launch(const void* rho, const void* maskf, const void* W, const void* N,
           float p, int nd, int ny, int nx, void* coeff, void* invd,
           void* coeff_lp, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + 31) / 32, (ny + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto lp = static_cast<__nv_bfloat16*>(coeff_lp);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  if (nd == 2) {
    assemble_2d_kernel<2, FULL><<<grid, block, 0, s>>>(
        f(rho), f(maskf), f(W), f(N), p, ny, nx, static_cast<float*>(coeff),
        static_cast<float*>(invd), lp);
  } else if (nd == 1) {
    assemble_2d_kernel<1, FULL><<<grid, block, 0, s>>>(
        f(rho), f(maskf), f(W), f(N), p, ny, nx, static_cast<float*>(coeff),
        static_cast<float*>(invd), lp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All nd*nd*9 planes (K1 full storage).
extern "C" int pyfem_assemble_2d(const void* rho, const void* maskf,
                                 const void* W, const void* N, float p,
                                 int nd, int ny, int nx, void* coeff,
                                 void* invd, void* coeff_lp, void* stream) {
  return launch<true>(rho, maskf, W, N, p, nd, ny, nx, coeff, invd,
                      coeff_lp, stream);
}

// The kept planes of sym_planes_2d (K1 half-symmetric storage).
extern "C" int pyfem_assemble_2d_sym(const void* rho, const void* maskf,
                                     const void* W, const void* N, float p,
                                     int nd, int ny, int nx, void* coeff,
                                     void* invd, void* coeff_lp,
                                     void* stream) {
  return launch<false>(rho, maskf, W, N, p, nd, ny, nx, coeff, invd,
                       coeff_lp, stream);
}

extern "C" const char* pyfem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
