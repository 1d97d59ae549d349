// K3: nodal density -> BC-eliminated 27-point stencil planes in
// half-symmetric or full storage + inverse diagonal (+ optional bf16
// copy), one pass, on an NVIDIA Hopper card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_assemble.py:
//   assemble_pack_3d with sym=True and sym=False (Pallas kernels
//   _kernel3d, _kernel3d_slab, _kernel3d_slab_mxu: three TPU tilings of
//   one computation).  Plain reference:
//   ops/fused_assemble.py::assemble_pack_3d_plain.
//
// Per node (iz, iy, ix), for the <= 8 valid elements
// e = (iz-az, iy-ay, ix-ax) around it:  Cq[o][q] = RAMP(sum_n N[q,n]
// rho[node n of e]) with o = az*4 + ay*2 + ax (phantom elements past the
// grid edge contribute 0); then for every kept plane k = (a, b, dz, dy,
// dx) of sym_planes_3d (ops/fused_smooth.py) in its storage order, or
// (full storage) every plane k = (a*nd + b)*27 + dz*9 + dy*3 + dx,
//   coeff[k] = rowm[a] * colm[b](iz+dz-1, iy+dy-1, ix+dx-1)
//              * sum_{o, q} W[k_full, o, q] * Cq[o][q]
// with a unit diagonal at fixed dofs (symmetric Dirichlet elimination;
// off-grid columns count as fixed), and invd[c] = rowm[c] / diag[c]
// (0 at fixed dofs).
//
// What bounds it on the H100: output bytes.  At nd=3 it writes 123 f32
// planes + 123 bf16 planes + 3 inverse-diagonal planes, 750 B per node,
// and reads 16 B of density and free mask per node (the 3x3x3
// neighbourhood reuse hits L1/L2): about 210 MB at 65^3, ~63 us at
// 3.35 TB/s.  The arithmetic (~2.3k FMAs per node, below) is a few
// percent of the card's f32 rate.  Full storage (243 planes) writes
// 1,470 B per node, ~404 MB at 65^3, ~121 us at 3.35 TB/s.
// What the design does about it: one thread per node, consecutive
// threads on consecutive x, so each plane's store is coalesced; every
// output is written once and nothing intermediate touches device
// memory.  The weights W (nd*nd*27 x 8 x 8 floats, 62 KB at nd=3) and
// the shape values N live in constant memory, uploaded on the launch
// stream before each launch (each level has its own W); with the plane
// loop fully unrolled every weight is a compile-time constant-bank
// operand of its FMA, and the element blocks a plane never touches
// (W = 0 by the stencil plan: an element must hold both nodes) are
// skipped at compile time, ~19 FMAs per plane instead of 64.  The 64
// Cq values of a node stay in registers (each element's Cq is
// recomputed by its 8 nodes: 512 FMAs per node, cheaper than a shared-
// memory exchange at this size).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NQ = 8;  // hex8 2x2x2 Gauss points
__constant__ float c_W[3 * 3 * 27 * 8 * NQ];
__constant__ float c_N[NQ * 8];

template <int ND, bool FULL>
__global__ void assemble_3d_kernel(
    const float* __restrict__ rho, const float* __restrict__ maskf, float p,
    int nz, int ny, int nx, float* __restrict__ coeff,
    float* __restrict__ invd, __nv_bfloat16* __restrict__ coeff_lp) {
  const int n = nz * ny * nx;
  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  if (node >= n) return;
  const int ix = node % nx;
  const int iy = (node / nx) % ny;
  const int iz = node / (nx * ny);
  const long long plane = n;
  const int sz = ny * nx;

  // density on the 3x3x3 neighbourhood, 0 off the grid
  float rv[3][3][3];
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int jz = iz + dz - 1, jy = iy + dy - 1, jx = ix + dx - 1;
        rv[dz][dy][dx] = (jz >= 0 && jz < nz && jy >= 0 && jy < ny &&
                          jx >= 0 && jx < nx)
                             ? __ldg(rho + node + (dz - 1) * sz +
                                     (dy - 1) * nx + (dx - 1))
                             : 0.f;
      }
    }
  }

  // RAMP material at the quad points of the 8 elements around the node
  float cq[8][NQ];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
    const int ez = iz - az, ey = iy - ay, ex = ix - ax;
    const bool valid = ez >= 0 && ez < nz - 1 && ey >= 0 && ey < ny - 1 &&
                       ex >= 0 && ex < nx - 1;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        // hex8 local node m at (dz, dy, dx): (0,0,0) (0,0,1) (0,1,1)
        // (0,1,0) (1,0,0) (1,0,1) (1,1,1) (1,1,0)
        const int lz = m >> 2, ly = (m >> 1) & 1, lx = (m ^ (m >> 1)) & 1;
        s += c_N[q * 8 + m] * rv[1 + lz - az][1 + ly - ay][1 + lx - ax];
      }
      cq[o][q] = valid ? s / (1.f + p * (1.f - s)) : 0.f;
    }
  }

  float rowm[ND], diag[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    rowm[c] = __ldg(maskf + c * plane + node);
    diag[c] = 1.f;
  }

  int si = 0;  // storage slot of the kept plane (constant once unrolled)
#pragma unroll
  for (int a = 0; a < ND; ++a) {
#pragma unroll
    for (int b = 0; b < ND; ++b) {
#pragma unroll
      for (int dz = 0; dz < (FULL ? 3 : 2); ++dz) {  // sym: no dz = 2
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            if (!FULL && dz == 1) {  // keep one of each (dy, dx) pair
              const int k2 = (a * ND + b) * 9 + dy * 3 + dx;
              const int p2 = (b * ND + a) * 9 + (2 - dy) * 3 + (2 - dx);
              if (p2 < k2) continue;
            }
            const int kf = (a * ND + b) * 27 + dz * 9 + dy * 3 + dx;
            float acc = 0.f;
#pragma unroll
            for (int o = 0; o < 8; ++o) {
              const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
              const int bz = az + dz - 1, by = ay + dy - 1, bx = ax + dx - 1;
              if (bz < 0 || bz > 1 || by < 0 || by > 1 || bx < 0 || bx > 1)
                continue;  // the element does not hold both nodes: W = 0
#pragma unroll
              for (int q = 0; q < NQ; ++q)
                acc += c_W[(kf * 8 + o) * NQ + q] * cq[o][q];
            }
            const int jz = iz + dz - 1, jy = iy + dy - 1, jx = ix + dx - 1;
            const float colm =
                (jz >= 0 && jz < nz && jy >= 0 && jy < ny && jx >= 0 &&
                 jx < nx)
                    ? __ldg(maskf + b * plane + node + (dz - 1) * sz +
                            (dy - 1) * nx + (dx - 1))
                    : 0.f;
            float v = acc * rowm[a] * colm;
            if (a == b && dz == 1 && dy == 1 && dx == 1) {
              v += 1.f - rowm[a];
              diag[a] = v;
            }
            const long long off = si * plane + node;
            coeff[off] = v;
            if (coeff_lp != nullptr) coeff_lp[off] = __float2bfloat16_rn(v);
            ++si;
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c)
    invd[c * plane + node] = rowm[c] / (diag[c] == 0.f ? 1.f : diag[c]);
}

}  // namespace

template <int ND>
void launch_nd(const float* rho, const float* maskf, float p, int nz, int ny,
               int nx, int full, float* coeff, float* invd,
               __nv_bfloat16* lp, cudaStream_t s) {
  const int n = nz * ny * nx;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  if (full) {
    assemble_3d_kernel<ND, true><<<grid, block, 0, s>>>(rho, maskf, p, nz,
                                                        ny, nx, coeff, invd,
                                                        lp);
  } else {
    assemble_3d_kernel<ND, false><<<grid, block, 0, s>>>(rho, maskf, p, nz,
                                                         ny, nx, coeff, invd,
                                                         lp);
  }
}

// full = 0: the kept planes of sym_planes_3d; full = 1: all nd*nd*27.
extern "C" int pyfem_assemble_3d(const void* rho, const void* maskf,
                                 const void* W, const void* N, float p,
                                 int nd, int nz, int ny, int nx, int full,
                                 void* coeff, void* invd, void* coeff_lp,
                                 void* stream) {
  if (nd != 1 && nd != 3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyToSymbolAsync(
      c_W, W, sizeof(float) * nd * nd * 27 * 8 * NQ, 0,
      cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemcpyToSymbolAsync(c_N, N, sizeof(float) * NQ * 8, 0,
                              cudaMemcpyDeviceToDevice, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto lp = static_cast<__nv_bfloat16*>(coeff_lp);
  auto c = static_cast<float*>(coeff);
  auto d = static_cast<float*>(invd);
  if (nd == 3) {
    launch_nd<3>(f(rho), f(maskf), p, nz, ny, nx, full, c, d, lp, s);
  } else {
    launch_nd<1>(f(rho), f(maskf), p, nz, ny, nx, full, c, d, lp, s);
  }
  return static_cast<int>(cudaGetLastError());
}
