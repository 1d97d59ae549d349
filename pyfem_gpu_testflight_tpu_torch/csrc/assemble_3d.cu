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
// and reads 16 B of density and free mask per node: about 210 MB at
// 65^3, ~63 us at 3.35 TB/s.  Full storage (243 planes) writes 1,470 B
// per node, ~404 MB, ~121 us.  The arithmetic is the structurally
// nonzero weights only (an element must hold both nodes): 512 FMAs per
// (a, b) block and node, 4,608 at nd=3 in full storage, 2,400 in half.
// What the design does about it:
// - The weights of the level live in shared memory, compacted by the
//   wrapper (ops/fused_assemble.py::k3_table, built once per level and
//   cached) to the structurally nonzero ones in the order the plane loop
//   consumes them: every load is a block-uniform 16-byte broadcast.  (In
//   the constant bank each FMA took a distinct operand from a 62 KB
//   working set, far past the constant cache.)
// - A block of 128 threads owns 256 nodes of a z-plane: 128 consecutive
//   slots, a slot being two x-adjacent nodes of a row (rows of more than
//   128 slots are cut into blocks of their own, so a block's boxes are at
//   most 256 nodes wide whatever nx is).  It stages the density and free
//   mask (one bit per component) of its nodes' 3x3x3 neighbourhood box,
//   then each element's 8 quadrature-point materials once (RAMP with the
//   fast division), in shared memory.  A node reads its 36 neighbours'
//   mask bits into a 64-bit word per component and, per element offset,
//   the 2 x 8 materials of its slot's two elements, so the plane loop has
//   no global loads and no predicates.
// - The plane loop runs over the (a, b) blocks of the stencil (9 at
//   nd=3), one code body per kind of block (ab_block), so the kernel is a
//   few thousand instructions; fully unrolled over all planes it was
//   ~100-200 KB of straight-line code and ran at ~10% of the issue rate
//   (a lone warp on a coarse level at ~9 cycles an instruction).  In a
//   block it takes the 9 (dy, dx) planes of one dz at a time, element
//   offset o outermost, so its FMAs feed 18 independent sums.  Each
//   weight broadcast feeds both nodes of the slot; the f32 planes are
//   stored as float2 and the bf16 copy as bf16x2 where the pair is 8 (4)
//   byte aligned, else as two scalars.
// Everything is written once; the sums are float32 on the CUDA cores (on
// the tensor cores float32 would be TF32).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int T = 128;                 // threads (node-pair slots) a block
constexpr int kSmemMax = 227 * 1024;   // dynamic shared memory a block may use

// element offset o holds both the node and its neighbour d - 1
__host__ __device__ constexpr bool holds(int o, int dz, int dy, int dx) {
  const int bz = (o >> 2) + dz - 1, by = ((o >> 1) & 1) + dy - 1,
            bx = (o & 1) + dx - 1;
  return bz >= 0 && bz <= 1 && by >= 0 && by <= 1 && bx >= 0 && bx <= 1;
}

// dynamic shared memory of a launch: the table (weights, then N), the
// element box 2 x (R + 1) x (W + 2) x 8 materials, the node box 3 x (R +
// 2) x (W + 3) densities and mask bytes, for a block's rows R <= rmax and
// width W <= wmax: rows of at most T slots take blocks of up to min(ny,
// (T - 1) / spr + 2) whole or partial rows, W <= nx; longer rows blocks
// of one row, W <= 2 T
__host__ __device__ constexpr size_t smem_bytes(int ntab, int ny, int nx) {
  const int spr = (nx + 1) / 2;
  const int rmax = spr > T ? 1 : ((T - 1) / spr + 2 < ny ? (T - 1) / spr + 2
                                                          : ny);
  const int wmax = spr > T ? 2 * T : nx;
  return 4 * static_cast<size_t>((ntab + 3) / 4 * 4) +
         4 * static_cast<size_t>(16 * (rmax + 1) * (wmax + 2)) +
         5 * static_cast<size_t>(3 * (rmax + 2) * (wmax + 3));
}

// The stored planes of one (a, b) block of the 27-point stencil: all 27
// (ALL, full storage) or, in half storage, those of sym_planes_3d, which
// depend only on whether a < b (UPPER: dz = 0 and 1), a == b (DIAG: dz =
// 0 and the first 5 (dy, dx) of dz = 1) or a > b (LOWER: dz = 0).
enum Kind { ALL, UPPER, DIAG, LOWER };

__host__ __device__ constexpr bool stored(int kind, int dz, int pl) {
  return kind == ALL ||
         (dz == 0 || (dz == 1 && (kind == UPPER ||
                                  (kind == DIAG && pl <= 4))));
}

// weights and planes of one (a, b) block of a kind
__host__ __device__ constexpr int kind_weights(int kind) {
  int w = 0;
  for (int dz = 0; dz < 3; ++dz)
    for (int o = 0; o < 8; ++o)
      for (int pl = 0; pl < 9; ++pl)
        if (stored(kind, dz, pl) && holds(o, dz, pl / 3, pl % 3)) w += 8;
  return w;
}

__host__ __device__ constexpr int kind_planes(int kind) {
  int k = 0;
  for (int dz = 0; dz < 3; ++dz)
    for (int pl = 0; pl < 9; ++pl) k += stored(kind, dz, pl) ? 1 : 0;
  return k;
}

// floats of the compacted weight table (ops/fused_assemble.py::k3_table
// without N): the (a, b) blocks' weights in storage order
template <int ND, bool FULL>
__host__ __device__ constexpr int table_floats() {
  return FULL ? ND * ND * kind_weights(ALL)
              : ND * (ND - 1) / 2 * (kind_weights(UPPER) +
                                     kind_weights(LOWER)) +
                    ND * kind_weights(DIAG);
}

// element offset o holds a stored plane of the kind at z-offset dz
__host__ __device__ constexpr bool uses(int kind, int dz, int o) {
  for (int pl = 0; pl < 9; ++pl)
    if (stored(kind, dz, pl) && holds(o, dz, pl / 3, pl % 3)) return true;
  return false;
}

// One (a, b) block for the two nodes of a slot: per dz, the 9 (dy, dx)
// planes at once, element offset o outermost, so consecutive FMAs feed up
// to 18 independent sums (each still over o, then q, ascending); then
// the column mask, the diagonal fix and the stores.  The code is the same
// for every (a, b) of a kind, so the kernel runs it in a loop: its
// instructions stay in the instruction cache (a fully unrolled plane loop
// was ~100-200 KB of straight-line code).  se: the slot's element (z, y,
// ix0 - 1) in the shared box, rs4 / ls4 its row / layer stride in float4s;
// wi, si: the block's first weight and storage slot; mrow / mcol: the
// free bits of components a / b.
template <int KIND>
__device__ __forceinline__ void ab_block(
    const float4* __restrict__ se, int ls4, int rs4,
    const float4* __restrict__ s_w4, int wi,
    long long si, unsigned long long mrow, unsigned long long mcol,
    bool diag, float* __restrict__ invd_a, long long n, long long node0,
    bool two, int par, int npar, float* __restrict__ coeff,
    __nv_bfloat16* __restrict__ coeff_lp) {
  auto bit = [](unsigned long long m, int i) -> bool { return (m >> i) & 1ull; };
  const float4* w4 = s_w4 + (wi >> 2);
  int wr = 0;    // weight relative to wi (constant once unrolled)
  int slot = 0;  // plane relative to si (constant once unrolled)
#pragma unroll
  for (int dz = 0; dz < 3; ++dz) {
    float acc[9][2];
#pragma unroll
    for (int pl = 0; pl < 9; ++pl) acc[pl][0] = acc[pl][1] = 0.f;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      if (!uses(KIND, dz, o)) continue;
      const int az = o >> 2, ay = (o >> 1) & 1, ax = o & 1;
      // the 8 materials of element (z - az, y - ay, ix0 + t - ax) for
      // node t = 0, 1: two neighbouring elements of the box, 64 bytes
      const float4* e = se - az * ls4 - ay * rs4 + 2 * (1 - ax);
      const float4 a0 = e[0], a1 = e[1], b0 = e[2], b1 = e[3];
      const float m0[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float m1[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int pl = 0; pl < 9; ++pl) {
        if (!stored(KIND, dz, pl) || !holds(o, dz, pl / 3, pl % 3))
          continue;  // not stored, or W = 0 by the plan
        const float4 w0 = w4[wr / 4], w1 = w4[wr / 4 + 1];
        wr += 8;
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          acc[pl][0] += w[q] * m0[q];
          acc[pl][1] += w[q] * m1[q];
        }
      }
    }
#pragma unroll
    for (int pl = 0; pl < 9; ++pl) {
      if (!stored(KIND, dz, pl)) continue;
      const int cb = (dz * 3 + pl / 3) * 4 + pl % 3;  // column bit, node 0
      float v0 = bit(mrow, 17) && bit(mcol, cb) ? acc[pl][0] : 0.f;
      float v1 = bit(mrow, 18) && bit(mcol, cb + 1) ? acc[pl][1] : 0.f;
      if (dz == 1 && pl == 4 && diag) {  // the diagonal of component a
        const float r0 = bit(mrow, 17) ? 1.f : 0.f;
        const float r1 = bit(mrow, 18) ? 1.f : 0.f;
        v0 += 1.f - r0;
        v1 += 1.f - r1;
        invd_a[node0] = r0 / (v0 == 0.f ? 1.f : v0);
        if (two) invd_a[node0 + 1] = r1 / (v1 == 0.f ? 1.f : v1);
      }
      const long long k = si + slot;
      const long long off = k * n + node0;
      const bool pair = two && (((static_cast<int>(k) & npar) ^ par) == 0);
      if (pair) {
        *reinterpret_cast<float2*>(coeff + off) = make_float2(v0, v1);
      } else {
        coeff[off] = v0;
        if (two) coeff[off + 1] = v1;
      }
      if (coeff_lp != nullptr) {
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(coeff_lp + off) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          coeff_lp[off] = __float2bfloat16_rn(v0);
          if (two) coeff_lp[off + 1] = __float2bfloat16_rn(v1);
        }
      }
      ++slot;
    }
  }
}

template <int ND, bool FULL>
__global__ void __launch_bounds__(T, 3) assemble_3d_kernel(
    const float* __restrict__ rho, const float* __restrict__ maskf,
    const float* __restrict__ tab, float p, int nz, int ny, int nx,
    int bpr, float* __restrict__ coeff, float* __restrict__ invd,
    __nv_bfloat16* __restrict__ coeff_lp) {
  constexpr int NW = table_floats<ND, FULL>();
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  const float4* s_w4 = smem4;
  const int tid = threadIdx.x;    // a thread a slot
  const int spr = (nx + 1) >> 1;  // slots a row
  const int z = blockIdx.y;
  // the block's slots s0..s1 of the plane: T consecutive ones, or with
  // bpr > 0 (rows of more than T slots) T of one row
  int s0, s1;
  if (bpr > 0) {
    const int row = blockIdx.x / bpr;
    s0 = row * spr + (blockIdx.x - row * bpr) * T;
    s1 = min(s0 + T, (row + 1) * spr) - 1;
  } else {
    s0 = blockIdx.x * T;
    s1 = min(s0 + T, ny * spr) - 1;
  }
  // the block's rows y0..y1, and its x range when it lies in one row
  const int y0 = s0 / spr, y1 = s1 / spr;
  int xlo = 0, xhi = nx - 1;
  if (y0 == y1) {
    xlo = 2 * (s0 - y0 * spr);
    xhi = min(2 * (s1 - y0 * spr) + 1, nx - 1);
  }
  const int R = y1 - y0 + 1, W = xhi - xlo + 1;
  // element box: layers z - 1, z, rows y0 - 1.., columns xlo - 1..; node
  // box: planes z - 1..z + 1, rows y0 - 1.., columns xlo - 1..
  const int EY = R + 1, EX = W + 2;
  const int NY = R + 2, NX = W + 3;
  float* s_e = s_w + (NW + 64 + 3) / 4 * 4;
  float* s_r = s_e + 2 * EY * EX * 8;
  unsigned char* s_m = reinterpret_cast<unsigned char*>(s_r + 3 * NY * NX);
  const long long n = static_cast<long long>(nz) * ny * nx;

  // the weights, then N (8 q x 8 nodes)
  for (int i = tid; i < (NW + 64) / 4; i += T)
    smem4[i] = __ldg(reinterpret_cast<const float4*>(tab) + i);
  // density and free-mask bits of the node box, 0 off the grid (an
  // off-grid column counts as fixed); U entries a thread at a time, their
  // loads all in flight before the first store
  constexpr int U = 4;
  const int nbox = 3 * NY * NX;
  for (int i0 = tid; i0 < nbox; i0 += U * T) {
    float r[U];
    unsigned m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      const int row = i / NX, sx = i - row * NX;
      const int sz = row / NY, sy = row - sz * NY;
      const int gz = z - 1 + sz, gy = y0 - 1 + sy, gx = xlo - 1 + sx;
      r[u] = 0.f;
      m[u] = 0;
      if (i < nbox && gz >= 0 && gz < nz && gy >= 0 && gy < ny && gx >= 0 &&
          gx < nx) {
        const long long g = (static_cast<long long>(gz) * ny + gy) * nx + gx;
        r[u] = __ldg(rho + g);
#pragma unroll
        for (int c = 0; c < ND; ++c)
          m[u] |= (__ldg(maskf + c * n + g) != 0.f ? 1u : 0u) << c;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * T;
      if (i < nbox) {
        s_r[i] = r[u];
        s_m[i] = static_cast<unsigned char>(m[u]);
      }
    }
  }
  __syncthreads();

  // RAMP material at the 8 points of every element of the box, once
  const float* s_n = s_w + NW;
  const int nel = 2 * EY * EX;
  for (int i = tid; i < nel; i += T) {
    const int row = i / EX, ex = i - row * EX;
    const int ez = row / EY, ey = row - ez * EY;
    const int gz = z - 1 + ez, gy = y0 - 1 + ey, gx = xlo - 1 + ex;
    const bool valid = gz >= 0 && gz < nz - 1 && gy >= 0 && gy < ny - 1 &&
                       gx >= 0 && gx < nx - 1;
    float rv[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      // hex8 local node m at (dz, dy, dx): (0,0,0) (0,0,1) (0,1,1)
      // (0,1,0) (1,0,0) (1,0,1) (1,1,1) (1,1,0)
      const int lz = m >> 2, ly = (m >> 1) & 1, lx = (m ^ (m >> 1)) & 1;
      rv[m] = s_r[((ez + lz) * NY + ey + ly) * NX + ex + lx];
    }
    float c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float sq = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) sq += s_n[q * 8 + m] * rv[m];
      // RAMP, with the fast division (2 ulp; 1 + p (1 - s) >= 1)
      c[q] = valid ? __fdividef(sq, 1.f + p * (1.f - sq)) : 0.f;
    }
    float4* dst = reinterpret_cast<float4*>(s_e + 8 * i);
    dst[0] = make_float4(c[0], c[1], c[2], c[3]);
    dst[1] = make_float4(c[4], c[5], c[6], c[7]);
  }
  __syncthreads();

  const int s = s0 + tid;
  if (s > s1) return;
  const int y = s / spr, ix0 = 2 * (s - y * spr);
  const bool two = ix0 + 1 < nx;
  const long long node0 = (static_cast<long long>(z) * ny + y) * nx + ix0;
  // the slot's materials stay in shared memory: se is element (z, y,
  // ix0 - 1) of the box, a row is rs4 float4s, a layer ls4; ab_block
  // reads the 2 elements of each offset it uses
  const int rs4 = EX * 2, ls4 = EY * rs4;
  const float4* se = reinterpret_cast<const float4*>(s_e) + ls4 +
                     (y - y0 + 1) * rs4 + (ix0 - xlo) * 2;
  // free bits of the 3 x 3 x 4 neighbours (z-1+dz, y-1+dy, ix0-1+xx),
  // bit (dz*3 + dy)*4 + xx, one word per component
  unsigned long long mb[ND];
#pragma unroll
  for (int c = 0; c < ND; ++c) mb[c] = 0ull;
#pragma unroll
  for (int dz = 0; dz < 3; ++dz)
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int xx = 0; xx < 4; ++xx) {
        const unsigned v = s_m[(dz * NY + y - y0 + dy) * NX + ix0 - xlo + xx];
#pragma unroll
        for (int c = 0; c < ND; ++c)
          mb[c] |= static_cast<unsigned long long>((v >> c) & 1u)
                   << ((dz * 3 + dy) * 4 + xx);
      }
  const int par = static_cast<int>(node0 & 1), npar = static_cast<int>(n & 1);
  auto sel = [&](int c) -> unsigned long long {
    if constexpr (ND == 1) return mb[0];
    else return c == 0 ? mb[0] : (c == 1 ? mb[1] : mb[2]);
  };

  // the (a, b) blocks in storage order, one at a time (not unrolled)
  int wi = 0;
  long long si = 0;
#pragma unroll 1
  for (int ab = 0; ab < ND * ND; ++ab) {
    const int a = ab / ND, b = ab % ND;
    const unsigned long long mrow = sel(a), mcol = sel(b);
    float* invd_a = invd + a * n;
    if constexpr (FULL) {
      ab_block<ALL>(se, ls4, rs4, s_w4, wi, si, mrow, mcol, a == b, invd_a,
                    n, node0, two, par, npar, coeff, coeff_lp);
      wi += kind_weights(ALL);
      si += kind_planes(ALL);
    } else if (a < b) {
      ab_block<UPPER>(se, ls4, rs4, s_w4, wi, si, mrow, mcol, false, invd_a,
                      n, node0, two, par, npar, coeff, coeff_lp);
      wi += kind_weights(UPPER);
      si += kind_planes(UPPER);
    } else if (a == b) {
      ab_block<DIAG>(se, ls4, rs4, s_w4, wi, si, mrow, mcol, true, invd_a,
                     n, node0, two, par, npar, coeff, coeff_lp);
      wi += kind_weights(DIAG);
      si += kind_planes(DIAG);
    } else {
      ab_block<LOWER>(se, ls4, rs4, s_w4, wi, si, mrow, mcol, false, invd_a,
                      n, node0, two, par, npar, coeff, coeff_lp);
      wi += kind_weights(LOWER);
      si += kind_planes(LOWER);
    }
  }
}

template <int ND, bool FULL>
int launch(const float* rho, const float* maskf, const float* tab, int ntab,
           float p, int nz, int ny, int nx, float* coeff, float* invd,
           __nv_bfloat16* lp, cudaStream_t s) {
  constexpr int NW = table_floats<ND, FULL>();
  if (ntab != NW + 64) return static_cast<int>(cudaErrorInvalidValue);
  const int spr = (nx + 1) / 2;
  const int bpr = spr > T ? (spr + T - 1) / T : 0;  // blocks a row
  const size_t smem = smem_bytes(ntab, ny, nx);
  if (smem > static_cast<size_t>(kSmemMax))  // none: at most ~101 KB
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = assemble_3d_kernel<ND, FULL>;
  if (smem > 48 * 1024) {
    // raised past the default 48 KiB once per card and size, not on
    // every launch
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
  const dim3 grid(bpr > 0 ? ny * bpr : (ny * spr + T - 1) / T, nz);
  kern<<<grid, T, smem, s>>>(rho, maskf, tab, p, nz, ny, nx, bpr, coeff,
                              invd, lp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab: ops/fused_assemble.py::k3_table, ntab floats (the compacted
// weights of the storage, then N); full = 0: the kept planes of
// sym_planes_3d, full = 1: all nd*nd*27.
extern "C" int pyfem_assemble_3d(const void* rho, const void* maskf,
                                 const void* tab, int ntab, float p, int nd,
                                 int nz, int ny, int nx, int full,
                                 void* coeff, void* invd, void* coeff_lp,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto lp = static_cast<__nv_bfloat16*>(coeff_lp);
  auto c = static_cast<float*>(coeff);
  auto d = static_cast<float*>(invd);
  if (nz < 1 || ny < 1 || nx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nd == 3)
    return full ? launch<3, true>(f(rho), f(maskf), f(tab), ntab, p, nz, ny,
                                  nx, c, d, lp, s)
                : launch<3, false>(f(rho), f(maskf), f(tab), ntab, p, nz,
                                   ny, nx, c, d, lp, s);
  if (nd == 1)
    return full ? launch<1, true>(f(rho), f(maskf), f(tab), ntab, p, nz, ny,
                                  nx, c, d, lp, s)
                : launch<1, false>(f(rho), f(maskf), f(tab), ntab, p, nz,
                                   ny, nx, c, d, lp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
