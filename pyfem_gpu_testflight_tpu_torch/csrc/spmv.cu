// U1: CSR sparse matrix-vector product y = A x, and
// U2: DIA (dense-diagonal) product y = sum_k dia[k, i] u[i + off_k] with
// its Dirichlet-masked form, on an NVIDIA Hopper card.
//
// Replaces no TPU kernel.  In the JAX package both are plain XLA: the
// AMG levels and the fine operator of unstructured.amg_pcg are DIA
// (ops/dia.py DiaOperator.matvec, a Python loop over the offsets that
// XLA fuses into one loop).  In eager PyTorch that loop is one launch or
// more per diagonal, and on an RCM-ordered unstructured mesh the band's
// diagonals are 0.3-2% full (1,031 diagonals of which ~14 a row are
// nonzero on the 1M-dof torque arm), so the port stores the AMG levels
// as CSR and runs U1 on them; U2 serves DiaOperator's own API.
// Plain references: ops/spmv.py::csr_matvec_plain, dia_matvec_plain.
//
// What bounds them on the H100: bytes.  U1 reads indptr (4 B a row),
// each entry's column (4 B) and value (4 or 8 B), x and writes y: about
// 130 MB in f32 and 198 MB in f64 on the arm's fine level (39 and 59 us
// at 3.35 TB/s); 2 flops an entry are far below the compute roof.  U2
// reads every stored diagonal whole, padding included: 4.34 GB in f32 on
// the arm's fine level (1.30 ms), 97 MB on the 2D bench grid's 21
// diagonals (29 us).
// What the design does about it: U1 gives each row a group of G lanes
// (G a power of two from 1 to 32, about an eighth of the mean row length:
// ops/spmv.py csr_group), which stride through the row's entries with
// coalesced loads of columns and values and reduce by warp shuffles in a
// fixed order; x is gathered through the read-only cache.  A group as
// wide as the row spent most of its time in shuffles and idle lanes (the
// arm's fine level, f32: 101 us at 16 lanes, 55 us at 2).  U2 runs one
// thread per row, x fastest: each diagonal is streamed once with
// coalesced loads, u read through the read-only cache, and the offsets
// are staged in shared memory in chunks of 1024.  Every output is written once; no atomics, so both
// results do not depend on the run.
#include <cuda_runtime.h>

namespace {

template <typename T, int G>
__global__ void csr_spmv_kernel(const int* __restrict__ indptr,
                                const int* __restrict__ indices,
                                const T* __restrict__ vals,
                                const T* __restrict__ x,
                                T* __restrict__ y, int n) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t / G;
  const int lane = threadIdx.x % G;
  T acc = T(0);
  if (row < n) {
    const int end = indptr[row + 1];
    for (int j = indptr[row] + lane; j < end; j += G) {
      acc += vals[j] * __ldg(x + indices[j]);
    }
  }
  // every lane of the warp reaches the shuffles (no early return)
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off, G);
  }
  if (lane == 0 && row < n) y[row] = acc;
}

template <typename T, int G>
int launch_csr(const void* indptr, const void* indices, const void* vals,
               const void* x, void* y, int n, cudaStream_t s) {
  const int block = 256;
  const long long threads = (long long)n * G;
  const unsigned grid = (unsigned)((threads + block - 1) / block);
  csr_spmv_kernel<T, G><<<grid, block, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int csr_dispatch(const void* indptr, const void* indices, const void* vals,
                 const void* x, void* y, int n, int group, cudaStream_t s) {
  switch (group) {
    case 1: return launch_csr<T, 1>(indptr, indices, vals, x, y, n, s);
    case 2: return launch_csr<T, 2>(indptr, indices, vals, x, y, n, s);
    case 4: return launch_csr<T, 4>(indptr, indices, vals, x, y, n, s);
    case 8: return launch_csr<T, 8>(indptr, indices, vals, x, y, n, s);
    case 16: return launch_csr<T, 16>(indptr, indices, vals, x, y, n, s);
    case 32: return launch_csr<T, 32>(indptr, indices, vals, x, y, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

constexpr int kChunk = 1024;  // offsets staged in shared memory at a time

template <typename T>
__global__ void dia_spmv_kernel(const int* __restrict__ offsets, int noffs,
                                const T* __restrict__ dia,
                                const T* __restrict__ u,
                                const unsigned char* __restrict__ mask,
                                T* __restrict__ y, int n) {
  __shared__ int soff[kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  T acc = T(0);
  for (int c0 = 0; c0 < noffs; c0 += kChunk) {
    const int cn = min(kChunk, noffs - c0);
    __syncthreads();
    for (int k = threadIdx.x; k < cn; k += blockDim.x) {
      soff[k] = offsets[c0 + k];
    }
    __syncthreads();
    if (i < n) {
      const T* d = dia + (long long)c0 * n + i;
      for (int k = 0; k < cn; ++k) {
        const long long j = (long long)i + soff[k];
        if (j >= 0 && j < n && !(mask != nullptr && mask[j])) {
          acc += d[(long long)k * n] * __ldg(u + j);
        }
      }
    }
  }
  if (i < n) y[i] = (mask != nullptr && mask[i]) ? u[i] : acc;
}

template <typename T>
int launch_dia(const void* offsets, int noffs, const void* dia,
               const void* u, const void* mask, void* y, int n,
               cudaStream_t s) {
  const int block = 256;
  dia_spmv_kernel<T><<<(n + block - 1) / block, block, 0, s>>>(
      static_cast<const int*>(offsets), noffs, static_cast<const T*>(dia),
      static_cast<const T*>(u), static_cast<const unsigned char*>(mask),
      static_cast<T*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// U1.  indptr (n+1) and indices (nnz) int32, vals/x/y float (f64 = 0) or
// double (f64 = 1); group = lanes per row, 1, 2, 4, 8, 16 or 32.
extern "C" int pyfem_csr_spmv(const void* indptr, const void* indices,
                              const void* vals, const void* x, void* y,
                              int n, int group, int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? csr_dispatch<double>(indptr, indices, vals, x, y, n, group, s)
             : csr_dispatch<float>(indptr, indices, vals, x, y, n, group, s);
}

// U2.  offsets (noffs) int32, dia (noffs, n) and u, y (n) in one type;
// mask (n) bool bytes or null: fixed entries of u read as 0 and y = u
// there (DiaOperator.bc_matvec).
extern "C" int pyfem_dia_spmv(const void* offsets, int noffs, const void* dia,
                              const void* u, const void* mask, void* y,
                              int n, int f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f64 ? launch_dia<double>(offsets, noffs, dia, u, mask, y, n, s)
             : launch_dia<float>(offsets, noffs, dia, u, mask, y, n, s);
}
