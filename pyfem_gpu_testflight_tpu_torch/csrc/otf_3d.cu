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
// With bf16 operands (the smoother's mxu_bf16 calls) the TPU kernel's
// matmul operands are rounded to bf16: w3 and wd (rounded by the wrapper),
// the shifted fields Y (rounded here on load) and B in the diagonal; the
// final B * Z product keeps B in f32.  Two bodies:
//   pyfem_otf_3d (otf_3d_kernel), the f32 body on the CUDA cores below
//     (float32 on the tensor cores would be TF32);
//   pyfem_otf_3d_tc (otf_3d_tc_kernel), the bf16-operand pass with Z on
//     the tensor cores (mma.sync bf16, f32 accumulate), as the TPU kernel
//     ran it on its matrix unit; see TcShape below.
//
// What bounds the f32 body on the H100: operations.  Counted as the TPU
// kernel does its dense matmuls, a pass is nd * (64 * 27 * nd + 64) =
// 15,744 MACs per node at nd=3: 8.6 GFLOP at 65^3, ~129 us at 67 TFLOP/s
// (f32, no tensor cores).  The weights that are zero by the stencil plan
// (an element must hold both nodes) need no work: 8 nd weights per
// (ca, o, q), ~4,900 MACs per node with the B * Z epilogue, 2.7 GFLOP,
// ~40 us.  The bytes are rho, the mask, x and the output, ~40 B per node
// (~11 MB, ~3 us); all bounds at the H100 SXM's published peaks.
// The earlier body held one node per thread and its 64 B values in
// registers and rebuilt each of the 81 coefficients from weights read as
// broadcast float4s from shared memory: 16 bytes to every lane for 4 FMAs.
// At 128 bytes a cycle that return path alone takes ~150 us at 65^3, and
// the body took 0.144 ms, 28% of its bound (NVIDIA H100 80GB HBM3, 700 W;
// PERF.md section 6).
// What this design does about it: fewer shared-memory bytes per FMA.  It
// takes the tensor-core body's per-offset form to the CUDA cores,
// register-tiled.  For each element offset o, Z[o][q] = sum_k W_o[ca][q][k]
// x_e[k] over the element's 8 nodes times nd (k = 8 nd), then acc[ca] +=
// sum_q B_(o,q) Z[o][q]; W_o is the same for every node of the uniform
// grid.  A quad of threads shares 4 nodes along x and lane l takes the
// quad points 2 l, 2 l + 1 of every component: per (o, k) one float4 of x
// (4 nodes) and 2 nd weights as float4s feed 4 x 2 nd FMAs, 2 bytes a
// FMA against 4.  A quad sum by shuffles closes each node.  A block owns
// a 16 x 4 x 2 node tile (128 threads) and stages in shared memory
// (dynamic) the weights in the order the lanes read them (ops/otf3d.py::
// f32_table), three copies of the x tile shifted by -1, 0, +1 in x (so
// the 4 nodes' neighbour values are always one aligned float4), the
// density tile with a one-node halo, and the RAMP material at the 8 quad
// points of each of the 3 x 5 x 17 elements touching the tile, computed
// once with explicitly rounded operations in the plain version's order,
// so B is bit-identical to the plain version's and so is its bf16
// rounding.  The diagonal (mode 0) is wd . B per node, each B read once.
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

// RAMP material at the quad points of each element touching a tile whose
// low corner is (z0, y0, x0): EZ_ x EY_ x EX_ elements, element (z0 - 1 +
// lz, y0 - 1 + ly, x0 - 1 + lx) with its low corner at entry (lz, ly, lx)
// of s_rho (the density tile with its one-node halo, (EZ_ + 1) x (EY_ + 1)
// x (EX_ + 1), 0 off the grid), into s_cq[q][lz][ly][lx]; 0 for elements
// past the grid.  NT_ threads.
template <int EZ_, int EY_, int EX_, int NT_>
__device__ __forceinline__ void tile_materials(const float* s_N,
                                               const float* s_rho,
                                               float* s_cq, int x0, int y0,
                                               int z0, int nz, int ny, int nx,
                                               float p, int tid) {
  constexpr int RY_ = EY_ + 1, RX_ = EX_ + 1;
  for (int i = tid; i < EZ_ * EY_ * EX_; i += NT_) {
    const int lx = i % EX_, ly = (i / EX_) % EY_, lz = i / (EX_ * EY_);
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
        const float t =
            __fmul_rn(s_N[q * 8 + m],
                      s_rho[((lz + mz) * RY_ + ly + my) * RX_ + lx + mx]);
        s = m == 0 ? t : __fadd_rn(s, t);
      }
      s_cq[i + q * EZ_ * EY_ * EX_] =
          valid ? __fdiv_rn(s, __fadd_rn(1.f, __fmul_rn(p, __fsub_rn(1.f, s))))
                : 0.f;
    }
  }
}

// The f32 body.  A quad of threads shares QN = 4 nodes along x; its lane l
// takes the quad points 2 l and 2 l + 1 of every component.  Per element
// offset o and contraction index k = (cb, m) a thread reads the 4 nodes'
// x values as one float4 (from one of three copies of the x tile shifted
// by -1, 0, +1 in x, so the 4 values are 16-byte aligned for any
// neighbour offset) and its 2 nd weights as float4s, and does 4 x 2 nd
// FMAs; then sum_q B Z per node, a quad sum by shuffles, and lane l
// finishes node l.  A block owns a 16 x 4 x 2 node tile (128 threads).
constexpr int QN = 4;
constexpr int FTX = 16, FTY = 4, FTZ = 2;
constexpr int FNT = FTX / QN * 4 * FTY * FTZ;  // threads: 4 lanes a quad
constexpr int FRX = FTX + 2, FRY = FTY + 2, FRZ = FTZ + 2;  // + halo
constexpr int FEX = FTX + 1, FEY = FTY + 1, FEZ = FTZ + 1;  // elements

template <int ND>
struct F32Shape {
  static constexpr int K = 8 * ND;            // (cb, m) per offset
  static constexpr int NO = 2 * ND;           // a lane's outputs (ca, qq)
  static constexpr int WS = (NO + 3) / 4 * 4;  // padded to float4s
  static constexpr int NW = 8 * K * 4 * WS;    // weights [o][k][l][WS]
  static constexpr int NTAB = NW + ND * NJ + NQ * 8;  // | wd | N
  static constexpr int XS = FRZ * FRY * FTX;   // one shifted x copy, one cb
  static constexpr int RT = FRZ * FRY * FRX;   // the density tile
  static constexpr int CQ = NQ * FEZ * FEY * FEX;
  // bytes of dynamic shared memory: tables | x copies | rho | cq
  static constexpr int SMEM = 4 * (NTAB + 3 * ND * XS + RT + CQ);
};

template <int ND>
__global__ void __launch_bounds__(FNT)
    otf_3d_kernel(const float* __restrict__ rho,
                  const float* __restrict__ maskf,
                  const float* __restrict__ tables,
                  const float* __restrict__ b, const float* __restrict__ x,
                  float* __restrict__ out, float p, int nz, int ny, int nx,
                  float omega, int mode) {
  using S = F32Shape<ND>;
  extern __shared__ __align__(16) float s_f[];
  const float* s_w = s_f;
  const float* s_wd = s_f + S::NW;
  const float* s_N = s_wd + ND * NJ;
  float* s_xs = s_f + S::NTAB;  // [3 shifts][ND][FRZ][FRY][FTX]
  float* s_rho = s_xs + 3 * ND * S::XS;
  float* s_cq = s_rho + S::RT;  // [NQ][FEZ][FEY][FEX]
  const int tid = threadIdx.x;
  const int l = tid & 3, quad = tid >> 2;
  const int qx = quad % (FTX / QN), qy = (quad / (FTX / QN)) % FTY,
            qz = quad / (FTX / QN * FTY);
  const int x0 = blockIdx.x * FTX, y0 = blockIdx.y * FTY,
            z0 = blockIdx.z * FTZ;
  const long long plane = static_cast<long long>(nz) * ny * nx;
  const long long sz = static_cast<long long>(ny) * nx;

  for (int i = tid; i < S::NTAB / 4; i += FNT)
    reinterpret_cast<float4*>(s_f)[i] =
        __ldg(reinterpret_cast<const float4*>(tables) + i);
  // the density on the tile + a one-node halo, 0 off the grid
  for (int i = tid; i < S::RT; i += FNT) {
    const int lx = i % FRX, ly = (i / FRX) % FRY, lz = i / (FRX * FRY);
    const int gx = x0 + lx - 1, gy = y0 + ly - 1, gz = z0 + lz - 1;
    const bool in = gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 &&
                    gz < nz;
    s_rho[i] =
        in ? __ldg(rho + gz * sz + static_cast<long long>(gy) * nx + gx)
           : 0.f;
  }
  // x as three copies: entry j of copy s is x at x0 + j + s - 1
  for (int i = tid; i < 3 * S::XS; i += FNT) {
    const int s = i / S::XS, r = i - s * S::XS;
    const int j = r % FTX, ly = (r / FTX) % FRY, lz = r / (FTX * FRY);
    const int gx = x0 + j + s - 1, gy = y0 + ly - 1, gz = z0 + lz - 1;
    const bool in = x != nullptr && gx >= 0 && gx < nx && gy >= 0 &&
                    gy < ny && gz >= 0 && gz < nz;
    const long long g = gz * sz + static_cast<long long>(gy) * nx + gx;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      s_xs[(s * ND + c) * S::XS + r] = in ? __ldg(x + c * plane + g) : 0.f;
  }
  __syncthreads();
  tile_materials<FEZ, FEY, FEX, FNT>(s_N, s_rho, s_cq, x0, y0, z0, nz, ny,
                                     nx, p, tid);
  __syncthreads();

  // B of node u of the quad at element offset o, quad point q
  auto bq = [&](int q, int o, int u) {
    const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
    return s_cq[((q * FEZ + qz + 1 - az) * FEY + qy + 1 - ay) * FEX +
                QN * qx + u + 1 - ax];
  };
  // acc[u][ca] = sum_o sum_(q of this lane) B Z[o][q], Z = W_o[ca][q] . x_e
  float acc[QN][ND];
#pragma unroll
  for (int u = 0; u < QN; ++u)
#pragma unroll
    for (int c = 0; c < ND; ++c) acc[u][c] = 0.f;
  if (x != nullptr) {
    // o stays a loop: unrolled, the compiler hoists the shared-memory
    // loads of all 8 offsets and runs out of registers
#pragma unroll 1
    for (int o = 0; o < 8; ++o) {
      const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
      float z[QN][S::NO];
#pragma unroll
      for (int u = 0; u < QN; ++u)
#pragma unroll
        for (int w = 0; w < S::NO; ++w) z[u][w] = 0.f;
#pragma unroll
      for (int k = 0; k < S::K; ++k) {
        const int cb = k / 8, m = k % 8;
        const int mz = m >> 2, my = (m >> 1) & 1, mx = m & 1;
        // the 4 nodes' neighbour m - o: copy mx - ax + 1
        const float4 xv = *reinterpret_cast<const float4*>(
            s_xs + ((mx - ax + 1) * ND + cb) * S::XS +
            ((qz + 1 + mz - az) * FRY + qy + 1 + my - ay) * FTX + QN * qx);
        const float xu[QN] = {xv.x, xv.y, xv.z, xv.w};
        const float* wrow = s_w + ((o * S::K + k) * 4 + l) * S::WS;
#pragma unroll
        for (int w4 = 0; w4 < S::WS / 4; ++w4) {
          const float4 wv = *reinterpret_cast<const float4*>(wrow + 4 * w4);
          const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * w4 + e >= S::NO) continue;
#pragma unroll
            for (int u = 0; u < QN; ++u) z[u][4 * w4 + e] += ww[e] * xu[u];
          }
        }
      }
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
#pragma unroll
        for (int u = 0; u < QN; ++u) {
          const float bv = bq(2 * l + qq, o, u);
#pragma unroll
          for (int ca = 0; ca < ND; ++ca) acc[u][ca] += bv * z[u][ca * 2 + qq];
        }
      }
    }
  }
  // the quad's sum over its lanes' quad points; lane l keeps node l
  float mine[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    mine[c] = 0.f;
#pragma unroll
    for (int u = 0; u < QN; ++u) {
      float v = acc[u][c];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (u == l) mine[c] = v;
    }
  }

  const int ix = x0 + QN * qx + l, iy = y0 + qy, iz = z0 + qz;
  if (ix >= nx || iy >= ny || iz >= nz) return;
  const long long node = iz * sz + static_cast<long long>(iy) * nx + ix;
  // the diagonal wd . B of this node, each B read once
  float dg[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) dg[c] = 0.f;
  if (mode == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float bj = bq(j % NQ, j / NQ, l);
#pragma unroll
      for (int c = 0; c < ND; ++c) dg[c] += s_wd[c * NJ + j] * bj;
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const long long i = c * plane + node;
    float d;
    const float rowm = __ldg(maskf + i);
    const float xc = s_xs[(1 * ND + c) * S::XS +
                          ((qz + 1) * FRY + qy + 1) * FTX + QN * qx + l];
    float a = 0.f;
    if (x != nullptr) a = rowm * mine[c] + (1.f - rowm) * xc;
    const float res = (b != nullptr ? __ldg(b + i) : 0.f) - a;
    if (mode == 0) {
      d = rowm * dg[c] + (1.f - rowm);
      const float invd = rowm / (d == 0.f ? 1.f : d);
      out[i] = xc + omega * invd * res;
    } else if (mode == 1) {
      out[i] = res;
    } else {
      out[i] = -res;
    }
  }
}

// Raises a kernel's dynamic shared-memory limit to smem once per card
// (raised[device]), not on every launch: the solves are host-bound.
int allow_smem(const void* kern, int smem, bool* raised) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool kept = dev >= 0 && dev < 16;
  if (kept && raised[dev]) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (kept) raised[dev] = true;
  return 0;
}

template <int ND>
int launch_nd(const float* rho, const float* maskf, const float* tables,
              const float* b, const float* x, float* out, float p, int nz,
              int ny, int nx, float omega, int mode, cudaStream_t s) {
  constexpr int smem = F32Shape<ND>::SMEM;
  static bool raised[16] = {};
  const int e = allow_smem(reinterpret_cast<const void*>(otf_3d_kernel<ND>),
                           smem, raised);
  if (e != 0) return e;
  const dim3 grid((nx + FTX - 1) / FTX, (ny + FTY - 1) / FTY,
                  (nz + FTZ - 1) / FTZ);
  otf_3d_kernel<ND><<<grid, FNT, smem, s>>>(rho, maskf, tables, b, x, out, p,
                                            nz, ny, nx, omega, mode);
  return static_cast<int>(cudaGetLastError());
}

// The bf16-operand pass on the tensor cores (the TPU kernel's matmul on
// its matrix unit).  The product Z = w3[ca] @ Y is zero wherever the
// element node - o does not hold the neighbour node + d - 1, so it runs as
// one small product per element offset o, over that element's 8 nodes m:
//   Z[node, (o, q)] = sum_{cb, m} x[cb](node + m - o) * w3o[ca][o][q][(cb, m)]
// with w3o the structurally nonzero weights of w3 (ops/otf3d.py::tc_table)
// and the same values, the same products and the same f32 accumulation as
// the dense Z.  Each is mma.sync m16n8k16 (bf16 operands, f32 accumulate):
// the 16 nodes of one x-row of the tile as M, (cb, m) as K (8 nd,
// zero-padded to KP) and q as N (8).  The epilogue forms sum_{o, q} B_(o,q)
// Z from the C fragments (each thread holds two nodes and two q) and a
// quad shuffle; then each thread finishes its node as the f32 body does.
template <int ND>
struct TcShape {
  static constexpr int K = 8 * ND;                // (cb, m) per offset
  static constexpr int KP = (K + 15) / 16 * 16;   // padded to k16 steps
  static constexpr int KS = KP + 8;  // smem row stride: conflict-free B loads
  static constexpr int KSTEPS = KP / 16;
  static constexpr int XT = RZ * RY * RX;         // one component's x tile
  // bytes of dynamic shared memory: w3o (bf16) | wd, N | rho | cq | ax | x
  static constexpr int W_BYTES = ND * 8 * NQ * KS * 2;
  static constexpr int SMEM = W_BYTES + 4 * (ND * NJ + NQ * 8 + XT +
                                             NQ * EZ * EY * EX + ND * NT) +
                              2 * ND * XT;
};

__device__ __forceinline__ uint32_t pack_bf16(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int ND>
__global__ void __launch_bounds__(NT)
    otf_3d_tc_kernel(const float* __restrict__ rho,
                     const float* __restrict__ maskf,
                     const uint16_t* __restrict__ w3t,
                     const float* __restrict__ tab,
                     const float* __restrict__ b, const float* __restrict__ x,
                     float* __restrict__ out, float p, int nz, int ny, int nx,
                     float omega, int mode) {
  using S = TcShape<ND>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* s_w = reinterpret_cast<const uint16_t*>(smem);
  float* s_wd = reinterpret_cast<float*>(smem + S::W_BYTES);
  float* s_N = s_wd + ND * NJ;
  auto s_rho = reinterpret_cast<float (*)[RY][RX]>(s_N + NQ * 8);
  auto s_cq = reinterpret_cast<float (*)[EZ][EY][EX]>(s_N + NQ * 8 + S::XT);
  float* s_ax = s_N + NQ * 8 + S::XT + NQ * EZ * EY * EX;
  uint16_t* s_x = reinterpret_cast<uint16_t*>(s_ax + ND * NT);
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const int tid = tx + TX * (ty + TY * tz);
  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY, z0 = blockIdx.z * TZ;
  const long long plane = static_cast<long long>(nz) * ny * nx;
  const long long sz = static_cast<long long>(ny) * nx;

  for (int i = tid; i < S::W_BYTES / 16; i += NT)
    reinterpret_cast<uint4*>(smem)[i] =
        __ldg(reinterpret_cast<const uint4*>(w3t) + i);
  for (int i = tid; i < ND * NJ + NQ * 8; i += NT) s_wd[i] = __ldg(tab + i);
  // density and the bf16-rounded iterate on the tile + a one-node halo
  for (int i = tid; i < S::XT; i += NT) {
    const int lx = i % RX, ly = (i / RX) % RY, lz = i / (RX * RY);
    const int gx = x0 + lx - 1, gy = y0 + ly - 1, gz = z0 + lz - 1;
    const bool in = gx >= 0 && gx < nx && gy >= 0 && gy < ny && gz >= 0 &&
                    gz < nz;
    const long long g = gz * sz + static_cast<long long>(gy) * nx + gx;
    s_rho[lz][ly][lx] = in ? __ldg(rho + g) : 0.f;
    if (x != nullptr) {
#pragma unroll
      for (int c = 0; c < ND; ++c)
        s_x[c * S::XT + i] = __bfloat16_as_ushort(
            __float2bfloat16_rn(in ? __ldg(x + c * plane + g) : 0.f));
    }
  }
  __syncthreads();
  tile_materials<EZ, EY, EX, NT>(s_N, &s_rho[0][0][0], &s_cq[0][0][0][0],
                                 x0, y0, z0, nz, ny, nx, p, tid);
  __syncthreads();

  if (x != nullptr) {
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c4 = lane & 3;
    // x-tile offsets of this thread's contraction indices k = (cb, m) for
    // the offset o = 0: per k-step, k = 16 s + 2 c4 + {0, 1, 8, 9}; -1
    // past 8 nd (the zero padding)
    int koff[S::KSTEPS][4];
#pragma unroll
    for (int st = 0; st < S::KSTEPS; ++st) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 16 * st + 2 * c4 + (e & 1) + (e >> 1) * 8;
        const int cb = k / 8, m = k % 8;
        koff[st][e] = k < S::K ? cb * S::XT + (m >> 2) * RY * RX +
                                     ((m >> 1) & 1) * RX + (m & 1)
                               : -1;
      }
    }
    for (int mt = warp; mt < TY * TZ; mt += NT / 32) {
      const int my = mt % TY, mz = mt / TY;  // the x-row of 16 nodes
      // the row's node g at its place in the x tile (one-node halo)
      const int base0 = ((mz + 1) * RY + my + 1) * RX + g + 1;
      const int base1 = base0 + 8;
      float s0[ND], s1[ND];
#pragma unroll
      for (int ca = 0; ca < ND; ++ca) s0[ca] = s1[ca] = 0.f;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
        const int ooff = az * RY * RX + ay * RX + ax;
        auto y = [&](int base, int off) -> uint16_t {
          return off < 0 ? static_cast<uint16_t>(0) : s_x[base + off - ooff];
        };
        uint32_t a[S::KSTEPS][4];
#pragma unroll
        for (int st = 0; st < S::KSTEPS; ++st) {
          a[st][0] = pack_bf16(y(base0, koff[st][0]), y(base0, koff[st][1]));
          a[st][1] = pack_bf16(y(base1, koff[st][0]), y(base1, koff[st][1]));
          a[st][2] = pack_bf16(y(base0, koff[st][2]), y(base0, koff[st][3]));
          a[st][3] = pack_bf16(y(base1, koff[st][2]), y(base1, koff[st][3]));
        }
        // B at this thread's nodes g, g + 8 and quad points 2 c4, 2 c4 + 1
        const float* c0 = &s_cq[2 * c4][mz + 1 - az][my + 1 - ay][1 - ax];
        const float* c1 =
            &s_cq[2 * c4 + 1][mz + 1 - az][my + 1 - ay][1 - ax];
        const float b00 = c0[g], b01 = c1[g], b10 = c0[g + 8],
                    b11 = c1[g + 8];
#pragma unroll
        for (int ca = 0; ca < ND; ++ca) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int st = 0; st < S::KSTEPS; ++st) {
            const uint16_t* bp =
                s_w + ((ca * 8 + o) * NQ + g) * S::KS + 16 * st + 2 * c4;
            mma_bf16(acc, a[st], *reinterpret_cast<const uint32_t*>(bp),
                     *reinterpret_cast<const uint32_t*>(bp + 8));
          }
          s0[ca] += b00 * acc[0] + b01 * acc[1];
          s1[ca] += b10 * acc[2] + b11 * acc[3];
        }
      }
#pragma unroll
      for (int ca = 0; ca < ND; ++ca) {
        float v0 = s0[ca], v1 = s1[ca];
        v0 += __shfl_xor_sync(0xffffffffu, v0, 1);
        v0 += __shfl_xor_sync(0xffffffffu, v0, 2);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 1);
        v1 += __shfl_xor_sync(0xffffffffu, v1, 2);
        if (c4 == 0) {
          s_ax[ca * NT + mt * TX + g] = v0;
          s_ax[ca * NT + mt * TX + g + 8] = v1;
        }
      }
    }
  }
  __syncthreads();

  const int ix = x0 + tx, iy = y0 + ty, iz = z0 + tz;
  if (ix >= nx || iy >= ny || iz >= nz) return;
  const long long node = iz * sz + static_cast<long long>(iy) * nx + ix;
  // the diagonal rnd(wd) . rnd(B), in the f32 body's order per component
  float d[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) d[c] = 0.f;
  if (mode == 0) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = j / NQ, az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
      const float bj =
          bf16_round(s_cq[j % NQ][tz + 1 - az][ty + 1 - ay][tx + 1 - ax]);
#pragma unroll
      for (int c = 0; c < ND; ++c) d[c] += s_wd[c * NJ + j] * bj;
    }
  }
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    const long long i = c * plane + node;
    const float rowm = __ldg(maskf + i);
    float acc = 0.f;
    if (x != nullptr)
      acc = rowm * s_ax[c * NT + tid] + (1.f - rowm) * __ldg(x + i);
    const float r = (b != nullptr ? __ldg(b + i) : 0.f) - acc;
    if (mode == 0) {
      const float dd = rowm * d[c] + (1.f - rowm);
      const float invd = rowm / (dd == 0.f ? 1.f : dd);
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
int launch_tc(const float* rho, const float* maskf, const uint16_t* w3t,
              const float* tab, const float* b, const float* x, float* out,
              float p, int nz, int ny, int nx, float omega, int mode,
              cudaStream_t s) {
  constexpr int smem = TcShape<ND>::SMEM;
  static bool raised[16] = {};
  const int e = allow_smem(
      reinterpret_cast<const void*>(otf_3d_tc_kernel<ND>), smem, raised);
  if (e != 0) return e;
  const dim3 block(TX, TY, TZ);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY, (nz + TZ - 1) / TZ);
  otf_3d_tc_kernel<ND><<<grid, block, smem, s>>>(
      rho, maskf, w3t, tab, b, x, out, p, nz, ny, nx, omega, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One stencil pass: mode 0 (sweep; x == nullptr: the elementwise first
// sweep), 1 (residual), 2 (negated residual); tables = the f32 body's
// weights (ops/otf3d.py::f32_table) | wd | N as one 16-byte aligned f32
// array.  Returns cudaGetLastError() of
// the launch.
extern "C" int pyfem_otf_3d(const void* rho, const void* maskf,
                            const void* tables, const void* b, const void* x,
                            void* out, float p, int nd, int nz, int ny,
                            int nx, float omega, int mode, void* stream) {
  if ((nd != 1 && nd != 3) || mode < 0 || mode > 2 ||
      (mode != 0 && x == nullptr) || (x == nullptr && b == nullptr) ||
      reinterpret_cast<uintptr_t>(tables) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto o = static_cast<float*>(out);
  if (nd == 3)
    return launch_nd<3>(f(rho), f(maskf), f(tables), f(b), f(x), o, p, nz,
                        ny, nx, omega, mode, s);
  return launch_nd<1>(f(rho), f(maskf), f(tables), f(b), f(x), o, p, nz, ny,
                      nx, omega, mode, s);
}

// The bf16-operand pass on the tensor cores (the mxu_bf16 calls): w3t =
// the structurally nonzero bf16 weights as (nd, 8 o, 8 q, KS) with zero
// padding (TcShape, ops/otf3d.py::tc_table), tab = float32 rnd(wd)
// (nd * 64) | N (64); otherwise as pyfem_otf_3d.  w3t 16-byte aligned.
extern "C" int pyfem_otf_3d_tc(const void* rho, const void* maskf,
                               const void* w3t, const void* tab,
                               const void* b, const void* x, void* out,
                               float p, int nd, int nz, int ny, int nx,
                               float omega, int mode, void* stream) {
  if ((nd != 1 && nd != 3) || mode < 0 || mode > 2 ||
      (mode != 0 && x == nullptr) || (x == nullptr && b == nullptr) ||
      reinterpret_cast<uintptr_t>(w3t) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto w = static_cast<const uint16_t*>(w3t);
  auto o = static_cast<float*>(out);
  if (nd == 3)
    return launch_tc<3>(f(rho), f(maskf), w, f(tab), f(b), f(x), o, p, nz,
                        ny, nx, omega, mode, s);
  return launch_tc<1>(f(rho), f(maskf), w, f(tab), f(b), f(x), o, p, nz, ny,
                      nx, omega, mode, s);
}
