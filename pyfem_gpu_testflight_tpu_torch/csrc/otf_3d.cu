// K6: the 3D 27-point stencil apply, damped-Jacobi sweep and residual with
// the coefficients rebuilt on the fly from the nodal density (no stored
// coefficient planes), one stencil pass per launch, on an NVIDIA Hopper
// card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_otf3d.py: otf_apply_3d,
//   Pallas kernel _kernel_otf (there all sweeps of a call ran in one
//   z-tiled pass with ghost planes and a z budget; here each pass is one
//   launch, so any number of sweeps works).  Plain reference:
//   ops/otf3d.py::otf_apply_3d_plain.
//
// Per node i and component ca, with B[o][q] = RAMP(N[q] . rho) of the
// element i - o (0 for elements past the grid) and x zero at fixed dofs:
//   (A x)[ca](i) = rowm[ca] * sum_{cb, d} c(ca, cb, d) * x[cb](i + d - 1)
//                 + (1 - rowm[ca]) * x[ca](i),
//   c(ca, cb, d) = sum_{o, q} w3[ca][o*8 + q][cb*27 + d] * B[o][q]
// which is the TPU kernel's rowm * sum_j B_j (w3 @ Y)_j with the two sums
// swapped: the assembled coefficient rebuilt per node.  The inverse
// diagonal is invd = rowm / (rowm * sum_j wd[ca][j] B_j + 1 - rowm).
//   mode 0 (sweep):     out = x + omega * invd * (b - A x)
//   mode 1 (residual):  out = b - A x
//   mode 2 (-residual): out = A x - b
// b == nullptr reads as 0 (modes 1/2 are then -A x / A x, the matvec);
// x == nullptr is the elementwise first sweep from x0 = 0 (mode 0 only).
// With bf16 = 1 the TPU kernel's matmul operands are rounded to bf16: w3
// and wd (rounded by the wrapper), the shifted fields Y (rounded here on
// load) and B in the diagonal; the coefficient rebuild keeps B in f32, as
// the TPU kernel's final B * Z product does, and all arithmetic is f32.
//
// What bounds it on the H100: operations.  Counted as the TPU kernel
// does its dense matmuls, a pass is nd * (64 * 27 * nd + 64) = 15,744
// MACs per node at nd=3: 8.6 GFLOP at 65^3, ~129 us at 67 TFLOP/s (f32,
// no tensor cores).  This kernel skips the weights that are zero by the
// stencil plan (an element must hold both nodes: sum over d of the
// elements holding node i and i + d - 1 is 64, so 8 * 64 = 512 MACs per
// (ca, cb) pair), ~4,900 MACs per node with the Y products: 2.7 GFLOP,
// ~40 us.  The bytes are rho, the mask, x and the output, ~40 B per node
// (~11 MB, ~3 us); all bounds at the H100 SXM's published peaks.
// Predicted before its first chip run: ~100-150 us per f32 pass at 65^3
// (a third of the f32 rate), no faster than K4's f32 matvec on stored
// planes (104 us on an NVIDIA H100 80GB HBM3 at a 700 W power limit).
// What the design does about it: a block owns a 16 x 8 x 2 node tile (256
// threads, one node each).  It stages in shared memory the density tile
// and the x tile, each with a one-node halo, and the weights: only the
// structurally nonzero ones (nd^2 * 512 floats, 18 KB at nd=3), in the
// order the unrolled loop consumes them (the wrapper gathers them,
// ops/otf3d.py::_compact_index), so each group of 8 quad-point weights is
// two broadcast float4 loads at compile-time offsets.  (A first version
// read the full 62 KB w3 table from constant memory: 1.92 ms per f32 pass
// at 65^3 on an NVIDIA H100 80GB HBM3 at 700 W, the per-node walk over a
// table far larger than the per-SM constant cache.)
// It computes the RAMP material at the 8 quad points of each of the
// 3 x 9 x 17 elements touching the tile once, with explicitly rounded
// operations in the plain version's order, so B is bit-identical to the
// plain version's and so is its bf16 rounding; then each thread keeps its
// 64 B values in registers and loops over the 27 * nd neighbour terms,
// rebuilding each coefficient with the loop fully unrolled.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int NQ = 8;               // hex8 2 x 2 x 2 Gauss points
constexpr int NJ = 8 * NQ;          // (element offset, quad point) pairs
constexpr int TX = 16, TY = 8, TZ = 2;
constexpr int NT = TX * TY * TZ;    // threads per block, one node each
constexpr int RX = TX + 2, RY = TY + 2, RZ = TZ + 2;  // nodes + halo
constexpr int EX = TX + 1, EY = TY + 1, EZ = TZ + 1;  // elements touched

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int ND, bool BF16>
__global__ void __launch_bounds__(NT)
    otf_3d_kernel(const float* __restrict__ rho,
                  const float* __restrict__ maskf,
                  const float* __restrict__ tables,
                  const float* __restrict__ b, const float* __restrict__ x,
                  float* __restrict__ out, float p, int nz, int ny, int nx,
                  float omega, int mode) {
  // tables: compact w3 (ND * ND * 512) | wd (ND * 64) | N (64)
  constexpr int NW = ND * ND * 512, NTAB = NW + ND * NJ + NQ * 8;
  __shared__ __align__(16) float s_tab[NTAB];
  const float* s_w = s_tab;
  const float* s_wd = s_tab + NW;
  const float* s_N = s_tab + NW + ND * NJ;
  __shared__ float s_rho[RZ][RY][RX];
  __shared__ float s_cq[NQ][EZ][EY][EX];
  __shared__ float s_x[ND][RZ][RY][RX];
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + TX * (ty + TY * tz);
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
  const long long plane = static_cast<long long>(nz) * ny * nx;
  const long long sz = static_cast<long long>(ny) * nx;

  for (int i = tid; i < NTAB / 4; i += NT)
    reinterpret_cast<float4*>(s_tab)[i] =
        __ldg(reinterpret_cast<const float4*>(tables) + i);
  // density and iterate on the tile + a one-node halo, 0 off the grid
  for (int i = tid; i < RZ * RY * RX; i += NT) {
    const int lx = i % RX, ly = (i / RX) % RY, lz = i / (RX * RY);
    const int gx = x0 + lx - 1, gy = y0 + ly - 1, gz = z0 + lz - 1;
    const bool in = gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 &&
                    gz < nz;
    const long long g = gz * sz + static_cast<long long>(gy) * nx + gx;
    s_rho[lz][ly][lx] = in ? __ldg(rho + g) : 0.f;
    if (x != nullptr) {
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float v = in ? __ldg(x + c * plane + g) : 0.f;
        s_x[c][lz][ly][lx] = BF16 ? bf16_round(v) : v;
      }
    }
  }
  __syncthreads();

  // RAMP material at the quad points of each element touching the tile;
  // element (z0 - 1 + lz, y0 - 1 + ly, x0 - 1 + lx) has its low corner
  // at s_rho[lz][ly][lx]
  for (int i = tid; i < EZ * EY * EX; i += NT) {
    const int lx = i % EX, ly = (i / EX) % EY, lz = i / (EX * EY);
    const int ez = z0 - 1 + lz, ey = y0 - 1 + ly, ex = x0 - 1 + lx;
    const bool valid = ez >= 0 && ez < nz - 1 && ey >= 0 && ey < ny - 1 &&
                       ex >= 0 && ex < nx - 1;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      // N . rho then RAMP, each operation rounded (no FMA contraction) in
      // the plain version's order: bit-identical B
      float s = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        // hex8 local node m at (dz, dy, dx): (0,0,0) (0,0,1) (0,1,1)
        // (0,1,0) (1,0,0) (1,0,1) (1,1,1) (1,1,0)
        const int mz = m >> 2, my = (m >> 1) & 1, mx = (m ^ (m >> 1)) & 1;
        const float t = __fmul_rn(s_N[q * 8 + m],
                                  s_rho[lz + mz][ly + my][lx + mx]);
        s = m == 0 ? t : __fadd_rn(s, t);
      }
      s_cq[q][lz][ly][lx] =
          valid ? __fdiv_rn(s, __fadd_rn(1.f, __fmul_rn(p, __fsub_rn(1.f, s))))
                : 0.f;
    }
  }
  __syncthreads();

  const int ix = x0 + tx, iy = y0 + ty, iz = z0 + tz;
  if (ix >= nx || iy >= ny || iz >= nz) return;
  const long long node = iz * sz + static_cast<long long>(iy) * nx + ix;

  float B[8][NQ];  // B[o][q]: element node - o, o = az*4 + ay*2 + ax
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      B[o][q] = s_cq[q][tz + 1 - az][ty + 1 - ay][tx + 1 - ax];
  }
  float rowm[ND], acc[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    rowm[c] = __ldg(maskf + c * plane + node);
    acc[c] = 0.f;
  }

  if (x != nullptr) {
    int off = 0;  // position in the compact weights (constant once unrolled)
#pragma unroll
    for (int cb = 0; cb < ND; ++cb) {
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float y = s_x[cb][tz + dz][ty + dy][tx + dx];
#pragma unroll
            for (int ca = 0; ca < ND; ++ca) {
              float c = 0.f;
#pragma unroll
              for (int o = 0; o < 8; ++o) {
                const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
                const int bz = az + dz - 1, by = ay + dy - 1, bx = ax + dx - 1;
                if (bz < 0 || bz > 1 || by < 0 || by > 1 || bx < 0 || bx > 1)
                  continue;  // the element does not hold both nodes: w = 0
                const float4 w0 = *reinterpret_cast<const float4*>(s_w + off);
                const float4 w1 =
                    *reinterpret_cast<const float4*>(s_w + off + 4);
                c += w0.x * B[o][0] + w0.y * B[o][1] + w0.z * B[o][2] +
                     w0.w * B[o][3] + w1.x * B[o][4] + w1.y * B[o][5] +
                     w1.z * B[o][6] + w1.w * B[o][7];
                off += 8;
              }
              acc[ca] += c * y;
            }
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < ND; ++c)
      acc[c] = rowm[c] * acc[c] +
               (1.f - rowm[c]) * __ldg(x + c * plane + node);
  }

#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const long long i = c * plane + node;
    const float r = (b != nullptr ? __ldg(b + i) : 0.f) - acc[c];
    if (mode == 0) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float bj = B[j / NQ][j % NQ];
        d += s_wd[c * NJ + j] * (BF16 ? bf16_round(bj) : bj);
      }
      d = rowm[c] * d + (1.f - rowm[c]);
      const float invd = rowm[c] / (d == 0.f ? 1.f : d);
      const float xc = x != nullptr ? __ldg(x + i) : 0.f;
      out[i] = xc + omega * invd * r;
    } else if (mode == 1) {
      out[i] = r;
    } else {
      out[i] = -r;
    }
  }
}

template <int ND>
void launch_nd(const float* rho, const float* maskf, const float* tables,
               const float* b,
               const float* x, float* out, float p, int nz, int ny, int nx,
               float omega, int mode, int bf16, cudaStream_t s) {
  const dim3 block(TX, TY, TZ);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + TZ - 1) / TZ);
  if (bf16) {
    otf_3d_kernel<ND, true><<<grid, block, 0, s>>>(
        rho, maskf, tables, b, x, out, p, nz, ny, nx, omega, mode);
  } else {
    otf_3d_kernel<ND, false><<<grid, block, 0, s>>>(
        rho, maskf, tables, b, x, out, p, nz, ny, nx, omega, mode);
  }
}

}  // namespace

// One stencil pass: mode 0 (sweep; x == nullptr: the elementwise first
// sweep), 1 (residual), 2 (negated residual); tables = the compact w3 |
// wd | N as one 16-byte aligned f32 array.  Returns cudaGetLastError() of
// the launch.
extern "C" int pyfem_otf_3d(const void* rho, const void* maskf,
                            const void* tables, const void* b, const void* x,
                            void* out, float p, int nd, int nz, int ny,
                            int nx, float omega, int mode, int bf16,
                            void* stream) {
  if ((nd != 1 && nd != 3) || mode < 0 || mode > 2 ||
      (mode != 0 && x == nullptr) || (x == nullptr && b == nullptr) ||
      reinterpret_cast<uintptr_t>(tables) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto o = static_cast<float*>(out);
  if (nd == 3) {
    launch_nd<3>(f(rho), f(maskf), f(tables), f(b), f(x), o, p, nz, ny, nx,
                 omega, mode, bf16, s);
  } else {
    launch_nd<1>(f(rho), f(maskf), f(tables), f(b), f(x), o, p, nz, ny, nx,
                 omega, mode, bf16, s);
  }
  return static_cast<int>(cudaGetLastError());
}
