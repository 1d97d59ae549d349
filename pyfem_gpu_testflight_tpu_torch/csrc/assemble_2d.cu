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
// that touch it:  Cq[o][q] = RAMP(sum_n N[q,n] rho[node n of elem]) with
// o = ay*2 + ax (phantom elements past the grid edge contribute 0), then
// for every stored plane k = (ca, cb, dy, dx)
//   coeff[k] = rowm[ca] * colm[cb](iy+dy-1, ix+dx-1)
//              * sum_{o, q} W[k, o, q] * Cq[o][q]
// with a unit diagonal at fixed dofs (symmetric Dirichlet elimination;
// off-grid columns count as fixed), and invd[c] = rowm[c] / diag[c]
// (0 at fixed dofs).
//
// What bounds it on the H100: output bytes.  At nd=2 it writes 36 f32
// planes + 36 bf16 planes + 2 inverse-diagonal planes and reads 12 B of
// density and free mask: 236 B per node, about 124 MB at 1025x513
// (~37 us at 3.35 TB/s).  Half storage writes 19 + 19 planes + 2: about
// 70 MB (~21 us).  The arithmetic is the structurally nonzero weights
// only (an element must hold both the node and its neighbour): 64 FMAs
// per (ca, cb) block and node, 256 at nd=2 in full storage, far below
// the card's float32 rate.
// What the design does about it (two forms, chosen by the launch: the
// window form for nd = 2 from WINDOW_MIN nodes, the tile form below it
// and for nd = 1, whichever ran faster on the card, PERF.md section 6):
// - The stores.  A plane holds ny*nx values, odd on every bench level, so
//   the planes start at every alignment, and a block's or a warp's stores
//   split 32-byte sectors with its neighbours'.  On the card such writes
//   ran at ~40% of the bytes bound with no arithmetic at all, and at ~88%
//   when every sector is written whole (store-only stand-ins, 1025x513
//   against 1024x512).  So a block owns NB consecutive nodes (in memory
//   order, across row ends), computes NB + H of them (H = a sector's bf16
//   values) into shared memory, and writes each plane (f32 planes, bf16
//   copy, inverse diagonal) as a window of NB values shifted to start on
//   a sector of that plane (the first block from node 0, the last up to
//   the end), a warp a plane, as 16-byte stores.
// - Stores and arithmetic overlap: the planes of one (a, b) block of the
//   stencil go to one of two buffers; after a barrier the warps write
//   them out and go on to the next (a, b) block, whose arithmetic runs
//   while the stores drain.
// - The weights of the level, compacted by the wrapper to the
//   structurally nonzero ones in the order the plane loop consumes them
//   (ops/fused_assemble.py::k1_table, built once per level and cached on
//   the host), travel by value in a __grid_constant__ parameter: every
//   weight is a constant-bank operand of its FMA, so the plane loop loads
//   no weight (the table is at most 272 floats).
// - Each element's 4 quadrature-point materials (RAMP with the fast
//   division) and each node's free-mask bits are staged once per block in
//   shared memory, per row piece of the block's nodes with a one-element
//   halo, each node loading only the columns it owns.  A thread computes
//   two x-adjacent nodes (where the row allows); the plane loop is fully
//   unrolled (nd <= 2: at most 256 FMAs a node), so its predicates and
//   shifts are all compile-time.
// - The tile form (assemble_2d_tiles) stages a tile of 4 rows x 32 node
//   pairs (its node and element boxes, one-element halo) and runs the
//   same plane loop, each thread storing its pair of every plane directly
//   (float2 / bf16x2 where aligned): one barrier, which is all that small
//   grids and few planes can pay for.
// Tried and lost (same-call device or CUDA-event times, PERF.md section
// 6): the weights read with a uniform __ldg per FMA, zeros included (the
// form this replaces); the tile form at nd = 2 on the fine levels, with
// the weights in the constant bank or in shared memory (its split
// sectors held both back); wider row tiles, memory-order node pairs,
// streaming stores, warp-shuffled pair stores and capped occupancy (all
// kept split sectors); the window form with the weights in shared memory,
// with whole node boxes staged, or with all planes staged before any
// store.  One node a thread (256 threads) ran the window form 6% faster
// at 1025x513 nd=2 (CUDA events); two a thread is kept.
// Everything is written once; the sums are float32 on the CUDA cores,
// over element offset, then quadrature point, ascending.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstring>

namespace {

constexpr int T = 128;         // threads a block
constexpr int NPT = 2;         // nodes a thread computes
constexpr int NC = NPT * T;    // nodes a block computes
constexpr int GB = 32;         // bytes of a store sector
constexpr int H = GB / 2;      // bf16 values a sector: the widest shift
constexpr int NB = NC - H;     // nodes a block owns (a multiple of H)
constexpr int SP = NC + 4;     // stage row: NC values + a 16-byte shift
static_assert(NB > 0 && NB % H == 0 && T % 32 == 0, "block shape");

// element offset o = ay*2 + ax holds both the node and its neighbour
// (dy - 1, dx - 1) of plane pl = dy*3 + dx
__host__ __device__ constexpr bool holds(int o, int pl) {
  const int by = (o >> 1) + pl / 3 - 1, bx = (o & 1) + pl % 3 - 1;
  return by >= 0 && by <= 1 && bx >= 0 && bx <= 1;
}

// plane pl of block (a, b) is stored: every plane in full storage; in
// half storage those of sym_planes_2d, kept unless the partner (b, a,
// 8 - pl) comes first in the full order
__host__ __device__ constexpr bool stored(bool full, int nd, int a, int b,
                                          int pl) {
  return full || (b * nd + a) * 9 + 8 - pl >= (a * nd + b) * 9 + pl;
}

// floats of the compacted weight table (k1_table without N)
template <int ND, bool FULL>
__host__ __device__ constexpr int table_floats() {
  int w = 0;
  for (int ab = 0; ab < ND * ND; ++ab)
    for (int o = 0; o < 4; ++o)
      for (int pl = 0; pl < 9; ++pl)
        if (stored(FULL, ND, ab / ND, ab % ND, pl) && holds(o, pl)) w += 4;
  return w;
}

// the kernel's constant-bank table: the weights, then N (4 q x 4 nodes)
template <int ND, bool FULL>
struct Table {
  float w[table_floats<ND, FULL>() + 16];
};

// shared memory: the staged materials (<= 2 (NC + rows) float4) and mask
// bytes (<= 3 (NC + 2 rows)), then, reusing it, two group buffers of GR
// rows of SP floats: the values of one (a, b) block's stored planes and,
// on the diagonal, the inverse diagonal, one column per node (rows <= NC)
constexpr int GR = 10;
constexpr int STAGE_FLOATS = 4 * 2 * 2 * NC + (3 * 3 * NC + 3) / 4;
constexpr int SMEM_FLOATS =
    STAGE_FLOATS > 2 * GR * SP ? STAGE_FLOATS : 2 * GR * SP;

// One plane's window [lo, hi) of nodes by one warp, values at
// s_row[node - j0 + sh] (sh = (base + j0) & 3, so the 16-byte chunks of
// the plane are 16-byte chunks of the row): 16-byte stores, lane l
// taking chunks l, l + 32, ..., then the values at the window's ends
// (at most E - 1 at each, in the grid's first and last blocks only).
template <typename V>
__device__ __forceinline__ void put_window(V* __restrict__ out, long long base,
                                           long long j0, long long lo,
                                           long long hi,
                                           const float* __restrict__ s_row,
                                           int lane) {
  constexpr int E = 16 / sizeof(V);  // values a 16-byte chunk
  if (lo >= hi) return;
  const long long a0 = base + lo, a1 = base + hi;
  const long long r0 = (base + j0) & ~3LL;  // plane address of s_row[0]
  long long b0 = (a0 + E - 1) & ~static_cast<long long>(E - 1);
  long long b1 = a1 & ~static_cast<long long>(E - 1);
  if (b1 < b0) b0 = b1 = a1;  // shorter than a chunk: the ends only
  const int nch = static_cast<int>((b1 - b0) / E);
  const float* s0 = s_row + (b0 - r0);
  V* o0 = out + b0;
#pragma unroll 2
  for (int c = lane; c < nch; c += 32) {
    const float4* src = reinterpret_cast<const float4*>(s0 + E * c);
    if constexpr (E == 4) {
      *reinterpret_cast<float4*>(o0 + E * c) = src[0];
    } else {
      const float4 u = src[0], v = src[1];
      __nv_bfloat162 h[4] = {__floats2bfloat162_rn(u.x, u.y),
                             __floats2bfloat162_rn(u.z, u.w),
                             __floats2bfloat162_rn(v.x, v.y),
                             __floats2bfloat162_rn(v.z, v.w)};
      *reinterpret_cast<uint4*>(o0 + E * c) = *reinterpret_cast<uint4*>(h);
    }
  }
  const int h0 = static_cast<int>(b0 - a0), h1 = static_cast<int>(a1 - b1);
  if (lane < h0 + h1) {
    const long long a = lane < h0 ? a0 + lane : b1 + (lane - h0);
    const float v = s_row[a - r0];
    if constexpr (E == 4) out[a] = v;
    else out[a] = __float2bfloat16_rn(v);
  }
}

template <int ND, bool FULL>
__global__ void __launch_bounds__(T) assemble_2d_kernel(
    const __grid_constant__ Table<ND, FULL> tab,
    const float* __restrict__ rho, const float* __restrict__ maskf, float p,
    int ny, int nx, float* __restrict__ coeff, float* __restrict__ invd,
    __nv_bfloat16* __restrict__ coeff_lp) {
  constexpr int NW = table_floats<ND, FULL>();
  __shared__ float4 smem4[(SMEM_FLOATS + 3) / 4];
  float* smem = reinterpret_cast<float*>(smem4);
  float4* s_e = smem4;
  unsigned char* s_m = reinterpret_cast<unsigned char*>(smem + 4 * 2 * 2 * NC);
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = ny * nx;  // < 2^31: the planes alone would outgrow the card
  const int j0 = blockIdx.x * NB;
  const int jend = j0 + NC < n ? j0 + NC : n;  // computed: [j0, jend)
  const int y0 = j0 / nx;

  // the nodes of the thread, j0 + NPT tid + h (x-adjacent where the row
  // allows), and the row piece each lies in: the block's nodes of that
  // row, [pa, pb]; a piece stages its element rows y - 1, y over columns
  // xa - 1 .. xb (2 (len + 1) elements) and its mask rows y - 1 .. y + 1
  // over xa - 1 .. xb + 1 (3 (len + 2) bytes), each node the columns it
  // owns; the pieces' boxes follow each other
  int y[NPT], x[NPT], kk[NPT], len[NPT], eoff[NPT], moff[NPT];
  bool act[NPT];
#pragma unroll
  for (int h = 0; h < NPT; ++h) {
    const int j = j0 + NPT * tid + h;
    act[h] = j < jend;
    const int jc = act[h] ? j : jend - 1;
    y[h] = jc / nx;
    x[h] = jc - y[h] * nx;
    const int rs = y[h] * nx;
    const int pa = j0 > rs ? j0 : rs;
    const int pb = jend - 1 < rs + nx - 1 ? jend - 1 : rs + nx - 1;
    const int r = y[h] - y0;
    kk[h] = jc - pa;
    len[h] = pb - pa + 1;
    eoff[h] = 2 * (pa - j0 + r);
    moff[h] = 3 * (pa - j0 + 2 * r);
  }

  // stage: a node owns element column x - 1 (and x, the piece's last
  // node) in element rows y - 1 and y, and mask column x (and x - 1, the
  // piece's first node; x + 1, its last) in rows y - 1 .. y + 1; 0 off
  // the grid (an off-grid column counts as fixed, a phantom element
  // contributes nothing).  Only what the node owns is loaded.
#pragma unroll
  for (int h = 0; h < NPT; ++h) {
    if (!act[h]) continue;
    const bool first = kk[h] == 0, last = kk[h] == len[h] - 1;
    float r[3][3];
    unsigned m[3][3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int xx = 0; xx < 3; ++xx) {
        const int gy = y[h] - 1 + dy, gx = x[h] - 1 + xx;
        const bool in = gy >= 0 && gy < ny && gx >= 0 && gx < nx;
        const int g = gy * nx + gx;
        r[dy][xx] = in && (xx < 2 || last) ? __ldg(rho + g) : 0.f;
        m[dy][xx] = 0u;
        if (in && (xx == 1 || (xx == 0 && first) || (xx == 2 && last))) {
#pragma unroll
          for (int c = 0; c < ND; ++c)
            m[dy][xx] |= (__ldg(maskf + c * n + g) != 0.f ? 1u : 0u) << c;
        }
      }
    const int mw = len[h] + 2, ew = len[h] + 1;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int xx = 0; xx < 3; ++xx)
        if (xx == 1 || (xx == 0 && first) || (xx == 2 && last))
          s_m[moff[h] + dy * mw + kk[h] + xx] =
              static_cast<unsigned char>(m[dy][xx]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (c == 1 && !last) continue;
        const int ey = y[h] - 1 + rr, ex = x[h] - 1 + c;
        const bool valid = ey >= 0 && ey < ny - 1 && ex >= 0 && ex < nx - 1;
        // local node order (0,0), (0,1), (1,1), (1,0) as (dy, dx)
        const float r0 = r[rr][c], r1 = r[rr][c + 1], r2 = r[rr + 1][c + 1],
                    r3 = r[rr + 1][c];
        float cq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nq = NW + q * 4;
          const float sq = tab.w[nq] * r0 + tab.w[nq + 1] * r1
                         + tab.w[nq + 2] * r2 + tab.w[nq + 3] * r3;
          // RAMP, with the fast division (2 ulp; 1 + p (1 - s) >= 1)
          cq[q] = valid ? __fdividef(sq, 1.f + p * (1.f - sq)) : 0.f;
        }
        s_e[eoff[h] + rr * ew + kk[h] + c] =
            make_float4(cq[0], cq[1], cq[2], cq[3]);
      }
  }
  __syncthreads();

  // each node's 4 elements (em[rr][c]: element (y - 1 + rr, x - 1 + c),
  // offset (ay, ax) = (1 - rr, 1 - c)) and its 3 x 3 free bits (bit 8 xx
  // + c of mb[dy]: node (y - 1 + dy, x - 1 + xx), component c)
  float em[NPT][2][2][4];
  unsigned mb[NPT][3];
#pragma unroll
  for (int h = 0; h < NPT; ++h) {
    const int mw = len[h] + 2, ew = len[h] + 1;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 v = s_e[eoff[h] + rr * ew + kk[h] + c];
        em[h][rr][c][0] = v.x;
        em[h][rr][c][1] = v.y;
        em[h][rr][c][2] = v.z;
        em[h][rr][c][3] = v.w;
      }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const unsigned char* row = s_m + moff[h] + dy * mw + kk[h];
      mb[h][dy] = row[0] | (row[1] << 8) | (row[2] << 16);
    }
  }
  __syncthreads();  // the staging area becomes the two group buffers

  // a plane's values go to row r of a group buffer, shifted by its
  // plane's alignment: plane k starts at k n, and (k n + j0) & 3 =
  // (k (n & 3)) & 3 as j0 is a multiple of 16; sp[m] serves k & 3 == m
  float* sp[NPT][4];
#pragma unroll
  for (int h = 0; h < NPT; ++h)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      sp[h][m] = smem + ((m * (n & 3)) & 3) + NPT * tid + h;
  const bool first = blockIdx.x == 0;

  // the (a, b) blocks in storage order: each into a group buffer
  // (alternating), then, after a barrier, written out as each plane's
  // sector-aligned window (a warp a plane) while the next block computes
  int si = 0;    // storage slot of the block's first plane
  int wi = 0;    // its first weight (constant once unrolled)
  int buf = 0;   // its group buffer
#pragma unroll
  for (int ab = 0; ab < ND * ND; ++ab) {
    const int a = ab / ND, b = ab % ND;
    int np = 0;  // stored planes of the block
#pragma unroll
    for (int pl = 0; pl < 9; ++pl) np += stored(FULL, ND, a, b, pl);
    if (np == 0) continue;
    const int gb = buf * GR * SP;
#pragma unroll
    for (int h = 0; h < NPT; ++h) {
      if (!act[h]) continue;
      auto free_at = [&](int dy, int xx, int c) -> bool {
        return (mb[h][dy] >> (8 * xx + c)) & 1u;
      };
      float acc[9];
#pragma unroll
      for (int pl = 0; pl < 9; ++pl) acc[pl] = 0.f;
      // element offset outermost: consecutive FMAs feed up to 9
      // independent sums, each still over o, then q, ascending
      int w = wi;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int ay = o >> 1, ax = o & 1;
#pragma unroll
        for (int pl = 0; pl < 9; ++pl) {
          if (!stored(FULL, ND, a, b, pl) || !holds(o, pl)) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[pl] += tab.w[w + q] * em[h][1 - ay][1 - ax][q];
          w += 4;
        }
      }
      const bool rm = free_at(1, 1, a);
      int row = 0;
#pragma unroll
      for (int pl = 0; pl < 9; ++pl) {
        if (!stored(FULL, ND, a, b, pl)) continue;
        float v = rm && free_at(pl / 3, pl % 3, b) ? acc[pl] : 0.f;
        if (a == b && pl == 4) {  // the diagonal of component a
          const float f = rm ? 1.f : 0.f;
          v += 1.f - f;
          sp[h][a & 3][gb + (GR - 1) * SP] = f / (v == 0.f ? 1.f : v);
        }
        sp[h][(si + row) & 3][gb + row * SP] = v;
        ++row;
      }
    }
    __syncthreads();
    // the block's planes (and, on the diagonal, invd[a]), a warp a row
    const int nrow = np + (a == b ? 1 : 0);
    for (int q = tid >> 5; q < nrow; q += T / 32) {
      const bool inv = q == np;
      const long long base = static_cast<long long>(inv ? a : si + q) * n;
      const float* s_row = smem + gb + (inv ? GR - 1 : q) * SP;
      // f32: sectors of GB / 4 values
      const int d4 = static_cast<int>((-(base + j0)) & (GB / 4 - 1));
      const int lo4 = first ? 0 : j0 + d4, hi4 = j0 + NB + d4;
      put_window(inv ? invd : coeff, base, j0, lo4 < n ? lo4 : n,
                 hi4 < n ? hi4 : n, s_row, lane);
      if (!inv && coeff_lp != nullptr) {  // bf16: sectors of GB / 2 values
        const int d2 = static_cast<int>((-(base + j0)) & (GB / 2 - 1));
        const int lo2 = first ? 0 : j0 + d2, hi2 = j0 + NB + d2;
        put_window(coeff_lp, base, j0, lo2 < n ? lo2 : n, hi2 < n ? hi2 : n,
                   s_row, lane);
      }
    }
    si += np;
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int pl = 0; pl < 9; ++pl)
        wi += stored(FULL, ND, a, b, pl) && holds(o, pl) ? 4 : 0;
    buf ^= 1;
  }
}

// The tile form (nd = 1, and grids below WINDOW_MIN nodes): a block of
// 128 threads owns TY rows x TX node pairs, stages the free bits of the
// tile's node box and its elements' materials (a one-element halo), and
// each thread stores its pair's value of every plane at once, as a float2
// (bf16x2) where the pair is aligned.  No barrier but the staging's: on
// small grids and few planes the stores split fewer sectors than the
// barriers and windows of the form above cost.
constexpr int TX = 32, TY = 4;               // node pairs a tile row, rows
constexpr int EX = 2 * TX + 1, EY = TY + 1;  // element box (x0 - 1, y0 - 1)
constexpr int MX = 2 * TX + 2, MY = TY + 2;  // node box (x0 - 1, y0 - 1)
constexpr int WINDOW_MIN = 1 << 16;          // nodes: the window form from

template <int ND, bool FULL>
__global__ void __launch_bounds__(TX * TY) assemble_2d_tiles(
    const __grid_constant__ Table<ND, FULL> tab,
    const float* __restrict__ rho, const float* __restrict__ maskf, float p,
    int ny, int nx, int tpr, float* __restrict__ coeff,
    float* __restrict__ invd, __nv_bfloat16* __restrict__ coeff_lp) {
  constexpr int NW = table_floats<ND, FULL>();
  constexpr int TT = TX * TY;
  __shared__ float4 s_e[EY * EX];
  __shared__ __align__(4) unsigned char s_m[MY * MX];
  const int tid = threadIdx.x;
  const int by = blockIdx.x / tpr, bx = blockIdx.x - by * tpr;
  const int y0 = by * TY, x0 = bx * 2 * TX;
  const int n = ny * nx;

  // free bits of the node box, 0 off the grid; the loads all in flight
  // before the first store
  {
    constexpr int U = (MY * MX + TT - 1) / TT;
    unsigned m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * TT;
      const int sy = i / MX, sx = i - sy * MX;
      const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
      m[u] = 0u;
      if (i < MY * MX && gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
        const int g = gy * nx + gx;
#pragma unroll
        for (int c = 0; c < ND; ++c)
          m[u] |= (__ldg(maskf + c * n + g) != 0.f ? 1u : 0u) << c;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (tid + u * TT < MY * MX)
        s_m[tid + u * TT] = static_cast<unsigned char>(m[u]);
  }
  // RAMP material at the 4 points of every element of the box, once
  {
    constexpr int U = (EY * EX + TT - 1) / TT;
    float r[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * TT;
      const int ey = i / EX, ex = i - ey * EX;
      const int gy = y0 - 1 + ey, gx = x0 - 1 + ex;
      r[u][0] = r[u][1] = r[u][2] = r[u][3] = 0.f;
      if (i < EY * EX && gy >= 0 && gy < ny - 1 && gx >= 0 && gx < nx - 1) {
        // local node order (0,0), (0,1), (1,1), (1,0) as (dy, dx)
        const int e0 = gy * nx + gx;
        r[u][0] = __ldg(rho + e0);
        r[u][1] = __ldg(rho + e0 + 1);
        r[u][2] = __ldg(rho + e0 + nx + 1);
        r[u][3] = __ldg(rho + e0 + nx);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = tid + u * TT;
      if (i >= EY * EX) continue;
      const int ey = i / EX, ex = i - ey * EX;
      const int gy = y0 - 1 + ey, gx = x0 - 1 + ex;
      const bool valid = gy >= 0 && gy < ny - 1 && gx >= 0 && gx < nx - 1;
      float c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nq = NW + q * 4;
        const float sq = tab.w[nq] * r[u][0] + tab.w[nq + 1] * r[u][1]
                       + tab.w[nq + 2] * r[u][2] + tab.w[nq + 3] * r[u][3];
        // RAMP, with the fast division (2 ulp; 1 + p (1 - s) >= 1)
        c[q] = valid ? __fdividef(sq, 1.f + p * (1.f - sq)) : 0.f;
      }
      s_e[i] = make_float4(c[0], c[1], c[2], c[3]);
    }
  }
  __syncthreads();

  const int tx = tid % TX, ty = tid / TX;
  const int y = y0 + ty, ix0 = x0 + 2 * tx;
  if (y >= ny || ix0 >= nx) return;
  const bool two = ix0 + 1 < nx;
  const long long node0 = static_cast<long long>(y) * nx + ix0;
  const long long nn = n;

  // the pair's 6 elements: em[r][c] is element (y - 1 + r, ix0 - 1 + c),
  // so node t takes offset (ay, ax) from em[1 - ay][1 + t - ax]
  float em[2][3][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 v = s_e[(ty + r) * EX + 2 * tx + c];
      em[r][c][0] = v.x;
      em[r][c][1] = v.y;
      em[r][c][2] = v.z;
      em[r][c][3] = v.w;
    }
  // free bits of the 3 x 4 nodes (y - 1 + dy, ix0 - 1 + xx): bit 8 xx + c
  // of mw[dy]
  unsigned mw[3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const unsigned short* row = reinterpret_cast<const unsigned short*>(
        s_m + (ty + dy) * MX + 2 * tx);
    mw[dy] = static_cast<unsigned>(row[0]) |
             (static_cast<unsigned>(row[1]) << 16);
  }
  auto free_at = [&](int dy, int xx, int c) -> bool {
    return (mw[dy] >> (8 * xx + c)) & 1u;
  };
  const int par = static_cast<int>(node0 & 1), npar = n & 1;

  int wi = 0;  // next weight of the table (constant once unrolled)
  int si = 0;  // storage slot of the next plane
#pragma unroll
  for (int ab = 0; ab < ND * ND; ++ab) {
    const int a = ab / ND, b = ab % ND;
    float acc[9][2];
#pragma unroll
    for (int pl = 0; pl < 9; ++pl) acc[pl][0] = acc[pl][1] = 0.f;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
      const int ay = o >> 1, ax = o & 1;
#pragma unroll
      for (int pl = 0; pl < 9; ++pl) {
        if (!stored(FULL, ND, a, b, pl) || !holds(o, pl)) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[pl][0] += tab.w[wi + q] * em[1 - ay][1 - ax][q];
          acc[pl][1] += tab.w[wi + q] * em[1 - ay][2 - ax][q];
        }
        wi += 4;
      }
    }
#pragma unroll
    for (int pl = 0; pl < 9; ++pl) {
      if (!stored(FULL, ND, a, b, pl)) continue;
      const int dy = pl / 3, dx = pl % 3;
      const bool r0 = free_at(1, 1, a), r1 = free_at(1, 2, a);
      float v0 = r0 && free_at(dy, dx, b) ? acc[pl][0] : 0.f;
      float v1 = r1 && free_at(dy, dx + 1, b) ? acc[pl][1] : 0.f;
      if (a == b && pl == 4) {  // the diagonal of component a
        const float f0 = r0 ? 1.f : 0.f, f1 = r1 ? 1.f : 0.f;
        v0 += 1.f - f0;
        v1 += 1.f - f1;
        const float d0 = f0 / (v0 == 0.f ? 1.f : v0);
        const float d1 = f1 / (v1 == 0.f ? 1.f : v1);
        const long long off = a * nn + node0;
        if (two && ((a & npar) ^ par) == 0) {
          *reinterpret_cast<float2*>(invd + off) = make_float2(d0, d1);
        } else {
          invd[off] = d0;
          if (two) invd[off + 1] = d1;
        }
      }
      const long long off = si * nn + node0;
      const bool pair = two && ((si & npar) ^ par) == 0;
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
      ++si;
    }
  }
}

template <int ND, bool FULL>
int launch(const float* rho, const float* maskf, const float* tab, int ntab,
           float p, int ny, int nx, float* coeff, float* invd,
           __nv_bfloat16* lp, cudaStream_t s) {
  Table<ND, FULL> t;
  if (ntab != static_cast<int>(sizeof(t.w) / sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  std::memcpy(t.w, tab, sizeof(t.w));
  const long long n = static_cast<long long>(ny) * nx;
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (ND == 1 || n < WINDOW_MIN) {
    const int tpr = ((nx + 1) / 2 + TX - 1) / TX;  // tiles a row of tiles
    const unsigned blocks = static_cast<unsigned>(tpr) * ((ny + TY - 1) / TY);
    assemble_2d_tiles<ND, FULL><<<blocks, TX * TY, 0, s>>>(
        t, rho, maskf, p, ny, nx, tpr, coeff, invd, lp);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + NB - 1) / NB);
    assemble_2d_kernel<ND, FULL><<<blocks, T, 0, s>>>(t, rho, maskf, p, ny,
                                                      nx, coeff, invd, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool FULL>
int dispatch(const void* rho, const void* maskf, const void* tab, int ntab,
             float p, int nd, int ny, int nx, void* coeff, void* invd,
             void* coeff_lp, void* stream) {
  if (ny < 1 || nx < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* q) { return static_cast<const float*>(q); };
  auto c = static_cast<float*>(coeff);
  auto d = static_cast<float*>(invd);
  auto lp = static_cast<__nv_bfloat16*>(coeff_lp);
  if (nd == 2)
    return launch<2, FULL>(f(rho), f(maskf), f(tab), ntab, p, ny, nx, c, d,
                           lp, s);
  if (nd == 1)
    return launch<1, FULL>(f(rho), f(maskf), f(tab), ntab, p, ny, nx, c, d,
                           lp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// tab: ops/fused_assemble.py::k1_table in HOST memory, ntab floats (the
// compacted weights of the storage, then N); it is copied into the
// launch's parameters.
// All nd*nd*9 planes (K1 full storage).
extern "C" int pyfem_assemble_2d(const void* rho, const void* maskf,
                                 const void* tab, int ntab, float p, int nd,
                                 int ny, int nx, void* coeff, void* invd,
                                 void* coeff_lp, void* stream) {
  return dispatch<true>(rho, maskf, tab, ntab, p, nd, ny, nx, coeff, invd,
                        coeff_lp, stream);
}

// The kept planes of sym_planes_2d (K1 half-symmetric storage).
extern "C" int pyfem_assemble_2d_sym(const void* rho, const void* maskf,
                                     const void* tab, int ntab, float p,
                                     int nd, int ny, int nx, void* coeff,
                                     void* invd, void* coeff_lp,
                                     void* stream) {
  return dispatch<false>(rho, maskf, tab, ntab, p, nd, ny, nx, coeff, invd,
                         coeff_lp, stream);
}

extern "C" const char* pyfem_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
