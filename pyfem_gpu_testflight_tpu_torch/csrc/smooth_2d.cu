// K2: damped-Jacobi sweeps, residual or matvec on the BC-eliminated
// 9-point stencil in full or half-symmetric storage, on an NVIDIA Hopper
// card.
//
// Replaces: pyfem_gpu_testflight_tpu/ops/pallas_smooth.py:
//   fused_sweeps_2d (Pallas kernel _kernel, with sym_list=None and with
//   the sym_list body of half storage).  Plain reference:
//   ops/fused_smooth.py::fused_sweeps_2d_plain.
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
//   sweep (the step kernel's mode 0):  x <- x + omega * invd * (b - A x)
//   residual (mode 1, or 2 negated):    b - A x, or A x - b
// b == nullptr reads as 0; from x0 = 0 the first sweep is elementwise
// (omega * invd * b).  Coefficients are f32 or bf16 (loaded as bf16,
// arithmetic in f32); fields are f32.
//
// Two kernels:
// - sweeps_2d_kernel[_b2] (pyfem_sweeps_2d on full storage,
//   pyfem_sweeps_2d_sym on the kept planes): a whole smoothing call, its
//   sweeps and residual, in one launch, as the TPU kernel's call is: each
//   tile is computed from the tile plus a ghost ring as wide as the call's
//   stencil steps, its planes read once (the kept planes on a ring one
//   node wider, for the partner terms).  The budget is kMaxSteps stencil
//   steps a launch; ops/fused_smooth.py::sweep_plan_2d splits a longer
//   call into groups, one launch each.
// - smooth_2d_kernel (pyfem_smooth_2d[_sym]): one stencil step a launch,
//   for the niter = 0 matvec and residual (one step either way).
//
// What bounds a call on the H100: bytes.  One pass reads the planes once,
// each input field once and writes each output once: bench 2D's bf16
// presmooth with its residual at 1025x513 nd=2 is 54.7 MB (16.3 us at
// 3.35 TB/s), the f32 postsmooth with the residual 96.8 MB (28.9 us);
// ~40 FMAs a node a step are nowhere near the compute roof.  The step
// kernel read every plane once a step, at 32-48 registers a thread (few
// coefficient loads in flight): 33-36 us a bf16 step and 43 us an f32
// one, so 78.0 us for the bf16 presmooth call and 128.8 us for the f32
// postsmooth call (device time after a flush that reads 1 GiB, NVIDIA
// H100 80GB HBM3 at 700 W; PERF.md section 6).
// What the one-pass design does about it: a block (16 warps at nd = 2, 8
// at nd = 1) owns a region of 32 columns by Region::rows rows and walks
// tiles (the grid sized to the card); while it computes one tile,
// cp.async stages the next tile's plane rows and field rows in the other
// of two shared-memory buffers, as the 16-byte chunks that cover them
// (aligned in the tensor, so each row carries its own shift; no register
// waits on a load).  A thread moves its nodes' coefficients into
// registers once a tile; x lives in two shared buffers, one read and one
// written a sweep, a barrier between.  Each sum keeps the step kernel's
// order (c2, dy, dx), so a call equals the step kernel's chain bit for bit
// (every call of chip_smoke.py --k2-witness); split into per-row partial
// sums, bench 2D's PCG count moved from 7 to 8.  The same calls in the same card call: 37.9-
// 38.1 us for the bf16 presmooth (43% of its one-pass bound) and 69.9-
// 70.0 us for the f32 postsmooth (41%); every coarser level of bench 2D
// 2-2.4x faster a call.  What holds it there: the staged bytes are ~1.5x
// the one pass (the ghost ring, a 32-column region, the window's fields,
// the chunks' alignment), and with one block an SM the tile's arithmetic
// only partly overlaps the next tile's staging; the f32 form of the
// presmooth (twice the plane bytes) takes 50 us, so the staging runs near
// 3 TB/s at the margin.  The bf16 instance at nd = 1 took 163-171
// registers, one block an SM: its postsmooth at 1025^2 read 32.9-33.6 us
// against the step kernel's 27.9-28.4 and its presmooth_resid 31.6 against
// 30.6-31.0; held to two blocks an SM (128 registers, no spill) they read
// 26.2 and 25.0 (no main path runs bf16 planes at nd = 1).
// Half storage (pyfem_sweeps_2d_sym) stages the 19 kept planes (nd = 2) on
// the region plus a ring of one, 0.72-0.79x the full call's bytes a tile:
// 33.5-33.7 us for bench 2D sym's bf16 presmooth with its residual (33% of
// its 11.0 us one-pass bound), 35.3 for its bf16 postsmooth and 51.3-51.5
// for the f32 postsmooth with the residual (35% of 18.2), against 56.0-56.3,
// 51.9 and 88.4-88.5 for the step kernel's chain it replaced (read-flushed
// device time, the same card call); on the 513x257 level the two
// postsmooth forms lose 3% to that chain (back to back, L2-warm), and every
// smaller level runs 1.4-2.2x faster.  A 24-row region (12 warps) won 7% at
// 1025x513 and lost ~1 us a call on every level from 257x129 down.
// Tried and lost (bf16 presmooth / bf16 postsmooth / f32 postsmooth with
// residual, nd=2, read-flushed device us, each against the parent's
// 78.0 / 72.2 / 128.8 in chip_smoke.py --stencil-2d-kernels): a block a
// tile with the coefficients loaded straight into registers 68.7 / 80.5
// / 61.5 (bf16 spills: each load in flight holds a register); cp.async of
// 4-byte words into shared memory, coefficients into registers 55.0 /
// 54.3 / 78.2 (161 registers on bf16, one block an SM, blocks loading and
// computing in lock-step waves); a warp streaming down a 32-column strip,
// each sweep one row behind the last, 67.2 / 69.7 / 126.2 (latency-bound,
// and the per-row partial sums above); persistent tiles double-buffered
// with 4-byte copies and the coefficients read from shared memory each
// step 59.8 / 61.4 / 109.7; with 16-byte chunks and interleaved sums, 8
// warps 39.9 / 41.1 / 69.0; staging by fixed (row, chunk) slots 39.4 -
// 43.1.  The niter = 0 forms stay on the step kernel: a form of this
// kernel with no sweep (the residual alone, g = 1) took 42.9 us for the
// f32 matvec against the step kernel's 37.5 at nd=2 and 25.5 against 16.0
// at nd=1 (1025^2); only bf16 nd=2's Chebyshev residual won (30.2 against
// 32.9), so that form was taken out and a group has at least one sweep.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstdint>

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

// ---------------------------------------------------------------------------
// The one-pass call (either storage): a group of sweeps (+ the residual) in
// one launch, each block reading its tiles' coefficients once.
// ---------------------------------------------------------------------------

constexpr int QW = 32;          // region columns: a warp's lanes
constexpr int kMaxSteps = 4;    // stencil steps of one launch (the budget)
constexpr int kMaxSweeps = kMaxSteps + 1;  // + the elementwise first sweep

// Rows of the region a block computes, by nd, on either storage
// (ops/fused_smooth.py::_SWEEP_ROWS_2D mirrors them, and
// tests/test_torch_smooth_tiles.py reads them here): two regions' staging
// fit a block's shared memory.  A warp takes one row of the region at
// nd = 2 and four at nd = 1 (each the faster on the card; on half
// storage 24 rows at nd = 2, two a warp, lost on the coarse levels:
// PERF.md section 6).
constexpr int kRows1 = 32, kRows2 = 16;  // nd = 1, 2

template <int ND>
struct Region {
  static constexpr int rows = ND == 2 ? kRows2 : kRows1;
  static constexpr int warps = ND == 2 ? 16 : 8;
};

struct SweepGroup {
  float omega[kMaxSweeps];  // per-sweep damping of this group
  int nsweeps;     // sweeps of the group, the elementwise first included
  int first_elem;  // 1: from x0 = 0, the first sweep is omega invd b
  int rmode;       // -1: no residual; 1: b - A x; 2: A x - b
  int g;           // ghost width: the group's stencil steps (>= 1)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The planes a block stages for one tile: on full storage all ND*ND*9 on
// the region; on half storage the kept planes on the region plus a ring of
// one, since the partner term of node i reads the kept value of node
// i - (d - 1).  Rows are staged as the 16-byte chunks (V values) that
// cover them, aligned in the tensor, so a row's first value sits s = e0
// mod V past the row's start in shared memory (e0 its element index:
// odd-sized planes start each row at another alignment): NC chunks a row
// from its first column's chunk, and every window row of the fields NCF
// chunks (34 columns).  Rows outside the grid are zeros.  A chunk's values
// outside the grid are read only by off-grid nodes, which are never
// updated or written, or as a partner off the grid, which is taken as 0;
// an aligned chunk never leaves the allocation.
template <int ND, bool FULL, typename CT>
struct Staged {
  static constexpr int K = FULL ? ND * ND * 9 : (ND * ND * 9 + ND) / 2;
  static constexpr int ring = FULL ? 0 : 1;
  static constexpr int rows = Region<ND>::rows + 2 * ring;
  static constexpr int V = 16 / sizeof(CT);
  static constexpr int NC = (QW + 2 * ring + V - 1 + V - 1) / V;
  static constexpr int PV = NC * V;  // values a staged row holds
};
constexpr int NCF = (QW + 2 + 3 + 3) / 4;  // field chunks a window row
constexpr int FP = NCF * 4;                // floats a staged field row

__device__ __forceinline__ float coeff_at(const float* p) { return *p; }
__device__ __forceinline__ float coeff_at(const __nv_bfloat16* p) {
  const unsigned u = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(u << 16);
}

// Shared memory of a block: two staging buffers (one tile's planes, and
// b, invd, x0 on the window) and the two x buffers.
template <int ND, bool FULL, typename CT>
struct Smem {
  using P = Staged<ND, FULL, CT>;
  static constexpr int QH = Region<ND>::rows;
  static constexpr int WH = QH + 2, WW = QW + 2;  // the window
  static constexpr int planes = sizeof(CT) * P::K * P::rows * P::PV;
  static constexpr int field = 4 * ND * WH * FP;
  static constexpr int stage = planes + 3 * field;  // planes, b, invd, x0
  static constexpr int bytes = 2 * stage + 2 * 4 * ND * WH * WW;
};

// One group of a smoothing call.  Tile (ty, tx) is tile_x = QW - 2 (g -
// 1) columns by tile_y = QH - 2 (g - 1) rows at (ty * tile_y, tx *
// tile_x); its region is the tile plus a ring of g - 1 nodes (QH x QW, a
// thread a column of QH / BY of them), computed from a window one node
// wider still (the x ring that the first stencil step reads, and on half
// storage the partners' kept planes).  After step j the region's values
// are right on the tile plus a ring of g - j, so after the g steps on the
// tile.  Off the grid x reads 0 and is never updated.
// A block walks tiles blockIdx.x, + gridDim.x, ... (the grid is sized to
// the card): while it computes one tile, cp.async stages the next one's
// planes and fields in the other buffer, so the card's memory stays busy
// through the arithmetic.  A thread moves its nodes' ND*ND*9 coefficients
// into registers once a tile (on half storage each kept plane's own value
// and, unless it is its own partner, its partner's: the kept value of node
// i - (d - 1), 0 where that node is off the grid).  Each stencil sweep
// reads x from one x buffer and writes the other; the residual and x are
// written on the tile.  A thread's R x ND sums are interleaved, each in
// the step kernel's order: (c2, dy, dx) on full storage, the kept planes'
// order (own term, then partner term) on half storage.
template <int ND, bool FULL, typename CT>
__device__ __forceinline__ void sweeps_2d_body(
    const CT* __restrict__ coeff, const float* __restrict__ invd,
    const float* __restrict__ b, const float* __restrict__ x0,
    float* __restrict__ xout, float* __restrict__ rout, int ny, int nx,
    const SweepGroup grp) {
  using S = Smem<ND, FULL, CT>;
  using P = Staged<ND, FULL, CT>;
  constexpr int BY = Region<ND>::warps, NT = QW * BY;
  constexpr int QH = S::QH, WH = S::WH, WW = S::WW, R = QH / BY;
  constexpr int K = ND * ND * 9;  // a node's coefficients, full order
  constexpr int KS = P::K, PR = P::rows, RING = P::ring;
  constexpr int V = P::V, PV = P::PV, NC = P::NC;
  extern __shared__ __align__(16) unsigned char smem[];
  auto planes = [&](int buf) {  // [KS][PR][PV]
    return reinterpret_cast<CT*>(smem + buf * S::stage);
  };
  auto field = [&](int buf, int f) {  // [ND][WH][FP]; 0 b, 1 invd, 2 x0
    return reinterpret_cast<float*>(smem + buf * S::stage + S::planes +
                                    f * S::field);
  };
  using XBuf = float[ND][WH][WW];
  XBuf* s_x = reinterpret_cast<XBuf*>(smem + 2 * S::stage);  // [2]

  const int g = grp.g;
  const int tile_x = QW - 2 * (g - 1), tile_y = QH - 2 * (g - 1);
  const int tiles_x = (nx + tile_x - 1) / tile_x;
  const int ntiles = tiles_x * ((ny + tile_y - 1) / tile_y);
  const long long plane = static_cast<long long>(ny) * nx;
  const int tid = threadIdx.y * QW + threadIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  // a row's shift (element index mod V) from its parts, in int:
  // plane k / component c, row y, first column x
  const int pm = static_cast<int>(plane & (V - 1)), xm = nx & (V - 1);
  const int pm4 = static_cast<int>(plane & 3), xm4 = nx & 3;
  auto fshift = [&](int c, int y, int x) {
    return (c * pm4 + y * xm4 + x) & 3;
  };

  // stage tile `tile` into buffer buf, as one commit group.  Item p <
  // SLOTS * M (threads take items p = tid, tid + NT, ...) is chunk j of
  // staged row r (slot p % SLOTS) of every M-th plane from p / SLOTS; the
  // fields' chunks (x0 only where it is given) are spread over the block.
  constexpr int SLOTS = PR * NC, M = NT >= SLOTS ? NT / SLOTS : 1;
  const int nfields = x0 != nullptr ? 3 : 2;
  auto stage = [&](int tile, int buf) {
    if (tile < ntiles) {
      const int ox = (tile % tiles_x) * tile_x - (g - 1) - RING;
      const int oy = (tile / tiles_x) * tile_y - (g - 1) - RING;
      for (int p = tid; p < SLOTS * M; p += NT) {
        const int slot = p % SLOTS, k0 = p / SLOTS;
        const int r = slot / NC, j = slot - r * NC, gy = oy + r;
        const bool rin = gy >= 0 && gy < ny;
        const int rowterm = gy * xm + ox;
        const CT* src = coeff + k0 * plane + static_cast<long long>(gy) * nx +
                        ox + j * V;
        CT* d = planes(buf) + (k0 * PR + r) * PV + j * V;
        for (int k = k0; k < KS; k += M) {
          const int s = (k * pm + rowterm) & (V - 1);  // the row's shift
          const int x = ox - s + j * V;                // the chunk's column
          if (rin && x + V > 0 && x < nx)
            cp_async16(d, src - s);
          else
            *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
          src += M * plane;
          d += M * PR * PV;
        }
      }
      const int fox = ox + RING, foy = oy + RING;  // the region's origin
      for (int i = tid; i < nfields * ND * WH * NCF; i += NT) {
        const int f = i / (ND * WH * NCF), fr = i - f * (ND * WH * NCF);
        const int c = fr / (WH * NCF), rem = fr - c * (WH * NCF);
        const int wy = rem / NCF, j = rem - wy * NCF;
        const int yy = foy - 1 + wy;
        const int x = fox - 1 - fshift(c, yy, fox - 1) + 4 * j;
        const float* src = f == 0 ? b : f == 1 ? invd : x0;
        float* d = field(buf, f) + (c * WH + wy) * FP + 4 * j;
        if (src != nullptr && yy >= 0 && yy < ny && x + 4 > 0 && x < nx)
          cp_async16(d, src + c * plane + static_cast<long long>(yy) * nx +
                            x);
        else
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // (A x)[c] at this thread's R nodes from x buffer cur and the nodes'
  // coefficients cf
  auto apply = [&](int cur, const float (&cf)[R][K], float (&ax)[R][ND]) {
    float xw[ND][R + 2][3];
#pragma unroll
    for (int c2 = 0; c2 < ND; ++c2)
#pragma unroll
      for (int i = 0; i < R + 2; ++i)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          xw[c2][i][dx] = s_x[cur][c2][ty * R + i][tx + dx];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < ND; ++c) ax[i][c] = 0.f;
    if constexpr (FULL) {
#pragma unroll
      for (int c2 = 0; c2 < ND; ++c2)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int c = 0; c < ND; ++c)
#pragma unroll
              for (int i = 0; i < R; ++i)
                ax[i][c] += cf[i][(c * ND + c2) * 9 + dy * 3 + dx] *
                            xw[c2][i + dy][dx];
    } else {
#pragma unroll
      for (int a = 0; a < ND; ++a)
#pragma unroll
        for (int bb = 0; bb < ND; ++bb)
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              const int k = (a * ND + bb) * 9 + dy * 3 + dx;
              const int pk = (bb * ND + a) * 9 + (2 - dy) * 3 + (2 - dx);
              if (pk < k) continue;  // sym_planes_2d's rule
#pragma unroll
              for (int i = 0; i < R; ++i)
                ax[i][a] += cf[i][k] * xw[bb][i + dy][dx];
              if (pk != k) {
#pragma unroll
                for (int i = 0; i < R; ++i)
                  ax[i][bb] += cf[i][pk] * xw[a][i + 2 - dy][2 - dx];
              }
            }
    }
  };

  const int nst = grp.nsweeps - grp.first_elem;  // stencil sweeps
  stage(blockIdx.x, 0);
  for (int it = 0, tile = blockIdx.x; tile < ntiles;
       ++it, tile += gridDim.x) {
    const int buf = it & 1;
    stage(tile + gridDim.x, buf ^ 1);  // the next tile, while this one runs
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int ox = (tile % tiles_x) * tile_x - (g - 1);
    const int oy = (tile / tiles_x) * tile_y - (g - 1);
    const int gx = ox + tx;
    const float* fb = field(buf, 0);
    const float* fd = field(buf, 1);
    // the iterate on the window: x0, or the elementwise first sweep
    // omega_0 invd b; 0 off the grid (a warp a window row)
    const float om0 = grp.omega[0];
    const float* fx = field(buf, 2);
    for (int row = ty; row < ND * WH; row += BY) {
      const int c = row / WH, wy = row - c * WH, yy = oy - 1 + wy;
      const int e0 = row * FP + fshift(c, yy, ox - 1);
      const bool rin = yy >= 0 && yy < ny;
      for (int wx = tx; wx < WW; wx += QW) {
        const int xx = ox - 1 + wx, e = e0 + wx;
        float v = 0.f;
        if (rin && xx >= 0 && xx < nx)
          v = grp.first_elem ? om0 * fd[e] * fb[e] : fx[e];
        s_x[0][c][wy][wx] = s_x[1][c][wy][wx] = v;
      }
    }
    __syncthreads();
    // this thread's nodes' coefficients (from the staged planes: plane k's
    // staged row pr, of shift s = element index mod V, holds staged
    // column pc at pc + s) and offsets in the staged fields
    float cf[R][K];
    int fe[R][ND];
    bool live[R];
    const CT* s_c = planes(buf);
    auto at = [&](int k, int pr, int pc) {
      const int s = (k * pm + (oy - RING + pr) * xm + ox - RING) & (V - 1);
      return coeff_at(s_c + (k * PR + pr) * PV + pc + s);
    };
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty * R + i, yy = oy + r;
      live[i] = yy >= 0 && yy < ny && gx >= 0 && gx < nx;
      if constexpr (FULL) {
#pragma unroll
        for (int k = 0; k < K; ++k) cf[i][k] = at(k, r, tx);
      } else {
        int si = 0;  // storage slot of the kept plane (constant once unrolled)
#pragma unroll
        for (int a = 0; a < ND; ++a)
#pragma unroll
          for (int bb = 0; bb < ND; ++bb)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
              for (int dx = 0; dx < 3; ++dx) {
                const int k = (a * ND + bb) * 9 + dy * 3 + dx;
                const int pk = (bb * ND + a) * 9 + (2 - dy) * 3 + (2 - dx);
                if (pk < k) continue;
                cf[i][k] = at(si, r + 1, tx + 1);
                if (pk != k) {
                  // the partner node i - (d - 1), staged one row and
                  // column further in
                  const int py = yy + 1 - dy, px = gx + 1 - dx;
                  cf[i][pk] = py >= 0 && py < ny && px >= 0 && px < nx
                                  ? at(si, r + 2 - dy, tx + 2 - dx)
                                  : 0.f;
                }
                ++si;
              }
      }
#pragma unroll
      for (int c = 0; c < ND; ++c)
        fe[i][c] = (c * WH + r + 1) * FP + tx + 1 + fshift(c, yy, ox - 1);
    }
    int cur = 0;
    for (int s = 0; s < nst; ++s) {
      const float om = grp.omega[grp.first_elem + s];
      float ax[R][ND];
      apply(cur, cf, ax);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (!live[i]) continue;
        const int wy = ty * R + i + 1, wx = tx + 1;
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          const float r = fb[fe[i][c]] - ax[i][c];
          s_x[cur ^ 1][c][wy][wx] = s_x[cur][c][wy][wx] + om * fd[fe[i][c]] * r;
        }
      }
      __syncthreads();
      cur ^= 1;
    }
    // outputs on the tile only (the ring's values are not right)
    float ax[R][ND];
    if (grp.rmode > 0) apply(cur, cf, ax);
    const int lx = tx - (g - 1);
    if (lx >= 0 && lx < tile_x && gx < nx) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int ly = ty * R + i - (g - 1), gy = oy + ty * R + i;
        if (ly < 0 || ly >= tile_y || gy >= ny) continue;
        const long long node = static_cast<long long>(gy) * nx + gx;
        const int wy = ty * R + i + 1, wx = tx + 1;
#pragma unroll
        for (int c = 0; c < ND; ++c) {
          xout[c * plane + node] = s_x[cur][c][wy][wx];
          if (grp.rmode > 0) {
            const float r = fb[fe[i][c]] - ax[i][c];
            rout[c * plane + node] = grp.rmode == 1 ? r : -r;
          }
        }
      }
    }
    __syncthreads();  // this tile's buffers are free for the tile after next
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

#define SWEEPS_2D_PARAMS                                                    \
  const CT *__restrict__ coeff, const float *__restrict__ invd,            \
      const float *__restrict__ b, const float *__restrict__ x0,           \
      float *__restrict__ xout, float *__restrict__ rout, int ny, int nx, \
      const SweepGroup grp

template <int ND, bool FULL, typename CT>
__global__ void __launch_bounds__(QW * Region<ND>::warps)
    sweeps_2d_kernel(SWEEPS_2D_PARAMS) {
  sweeps_2d_body<ND, FULL, CT>(coeff, invd, b, x0, xout, rout, ny, nx, grp);
}

// The bf16 instances at nd = 1, held to two blocks an SM (at most 128
// registers; their shared memory fits twice): at 171 registers full
// storage ran one block an SM and its postsmooth at 1025^2 lost to the
// step kernel (PERF.md section 6).  Naming the minimum for the other
// instances too changes their code, so they keep the kernel above.
template <int ND, bool FULL, typename CT>
__global__ void __launch_bounds__(QW * Region<ND>::warps, 2)
    sweeps_2d_kernel_b2(SWEEPS_2D_PARAMS) {
  sweeps_2d_body<ND, FULL, CT>(coeff, invd, b, x0, xout, rout, ny, nx, grp);
}
#undef SWEEPS_2D_PARAMS

template <int ND, bool FULL, typename CT>
constexpr auto sweeps_kernel() {
  if constexpr (ND == 1 && sizeof(CT) == 2)
    return &sweeps_2d_kernel_b2<ND, FULL, CT>;
  else
    return &sweeps_2d_kernel<ND, FULL, CT>;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

template <int ND, bool FULL, typename CT>
int launch_group(const void* coeff, const float* invd, const float* b,
                 const float* x0, float* xout, float* rout, int ny, int nx,
                 const SweepGroup& grp, int tile_y, int tile_x,
                 cudaStream_t s) {
  using S = Smem<ND, FULL, CT>;
  constexpr int BY = Region<ND>::warps;
  static_assert(S::bytes <= 227 * 1024 && S::QH % BY == 0, "region");
  if (tile_x != QW - 2 * (grp.g - 1) || tile_y != S::QH - 2 * (grp.g - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = sweeps_kernel<ND, FULL, CT>();
  static const int occ = [] {
    cudaFuncSetAttribute(sweeps_kernel<ND, FULL, CT>(),
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         S::bytes);
    int v = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, sweeps_kernel<ND, FULL, CT>(), QW * BY, S::bytes);
    return v;
  }();
  if (occ < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles = static_cast<long long>((nx + tile_x - 1) / tile_x) *
                           ((ny + tile_y - 1) / tile_y);
  const long long cap = static_cast<long long>(occ) * sm_count();
  kernel<<<static_cast<unsigned>(ntiles < cap ? ntiles : cap), dim3(QW, BY),
           S::bytes, s>>>(static_cast<const CT*>(coeff), invd, b, x0, xout,
                          rout, ny, nx, grp);
  return static_cast<int>(cudaGetLastError());
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

// K2 and K2-sym, the one-pass call: one group of a smoothing call,
// nsweeps >= 1 sweeps with damping omegas[0..nsweeps) (host memory) from
// x0 (first_elem = 1: from x0 = 0, x0 == nullptr, the first sweep
// elementwise) into xout, then with rmode 1 or 2 the residual into rout
// (rmode -1: none).  The launch's geometry comes
// from ops/fused_smooth.py::sweep_plan_2d and is checked here: the ghost
// width g must be the group's stencil steps (at least 1, at most
// kMaxSteps), the tile the instance's region less a ring of g - 1.
#define SWEEPS_ENTRY_PARAMS                                                 \
  const void *coeff, int coeff_bf16, const void *invd, const void *b,      \
      const void *x0, void *xout, void *rout, const float *omegas,         \
      int nsweeps, int first_elem, int rmode, int g, int tile_y,           \
      int tile_x, int nd, int ny, int nx, void *stream
#define SWEEPS_ENTRY_ARGS                                                   \
  coeff, coeff_bf16, invd, b, x0, xout, rout, omegas, nsweeps, first_elem, \
      rmode, g, tile_y, tile_x, nd, ny, nx, stream

namespace {

template <bool FULL>
int sweeps_call(SWEEPS_ENTRY_PARAMS) {
  const int steps = nsweeps - first_elem + (rmode > 0 ? 1 : 0);
  if (invd == nullptr || xout == nullptr || nsweeps < 1 ||
      nsweeps > kMaxSweeps || (first_elem != 0 && first_elem != 1) ||
      (first_elem == 1) != (x0 == nullptr) ||
      (rmode != -1 && rmode != 1 && rmode != 2) ||
      (rmode > 0) != (rout != nullptr) ||
      (b == nullptr && first_elem == 1) || g != (steps > 0 ? steps : 1) ||
      g > kMaxSteps || (nd != 1 && nd != 2) ||
      ((reinterpret_cast<uintptr_t>(coeff) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(invd) | reinterpret_cast<uintptr_t>(x0)) &
       15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepGroup grp{};
  for (int i = 0; i < nsweeps; ++i) grp.omega[i] = omegas[i];
  grp.nsweeps = nsweeps;
  grp.first_elem = first_elem;
  grp.rmode = rmode;
  grp.g = g;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* xo = static_cast<float*>(xout);
  float* ro = static_cast<float*>(rout);
  if (nd == 2)
    return coeff_bf16 ? launch_group<2, FULL, __nv_bfloat16>(
                            coeff, f(invd), f(b), f(x0), xo, ro, ny, nx, grp,
                            tile_y, tile_x, s)
                      : launch_group<2, FULL, float>(
                            coeff, f(invd), f(b), f(x0), xo, ro, ny, nx, grp,
                            tile_y, tile_x, s);
  return coeff_bf16 ? launch_group<1, FULL, __nv_bfloat16>(
                          coeff, f(invd), f(b), f(x0), xo, ro, ny, nx, grp,
                          tile_y, tile_x, s)
                    : launch_group<1, FULL, float>(
                          coeff, f(invd), f(b), f(x0), xo, ro, ny, nx, grp,
                          tile_y, tile_x, s);
}

}  // namespace

// All nd*nd*9 planes (K2 full storage).
extern "C" int pyfem_sweeps_2d(SWEEPS_ENTRY_PARAMS) {
  return sweeps_call<true>(SWEEPS_ENTRY_ARGS);
}

// The kept planes of sym_planes_2d (K2 half-symmetric storage).
extern "C" int pyfem_sweeps_2d_sym(SWEEPS_ENTRY_PARAMS) {
  return sweeps_call<false>(SWEEPS_ENTRY_ARGS);
}
#undef SWEEPS_ENTRY_PARAMS
#undef SWEEPS_ENTRY_ARGS
