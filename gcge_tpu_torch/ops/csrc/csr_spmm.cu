// Irregular (CSR) sparse matrix times multivector on Hopper (kernels 5 and 6
// of the port).
//
//   y[i, j] = sum_{p = rowptr[i]}^{rowptr[i+1]-1} values[p] * x[colidx[p], j]
//
// Replaces gcge_tpu/ops/onehot_pallas.py:_onehot_spmm_t (f32: per packed
// (row-tile, column-window) pair two MXU products against one-hot select and
// scatter matrices built in the kernel, because the TPU has no gather) and
// :_onehot_spmm_t_df64 (the same product to ~2^-40 relative from bf16 planes,
// Dekker products and integer-slice scatters, because the TPU has no f64).
// Hopper has a gather and native f64, so neither the pairs nor the planes are
// carried over: both kernels work on plain CSR.  In both the sum runs in T,
// in CSR order (entries sorted by column within a row), one fused
// multiply-add a term, with no atomics: two launches on the same inputs give
// the same bits.  x and y are logical (n_cols, m) and (n, m)
// matrices given by 2-D strides, so both serve the row-major (n, m) layout of
// CsrOperator.matvec and the transposed (m, n) layout of matvec_t, views
// included, without a copy.
//
// Kernel 6, csr_spmm<double>: one thread per output element, the contiguous
//   dimension of y fastest.  At the irregular slice's shape (n = 250,047,
//   nnz = 4,004,065, m = 10) one call must move 12 B per nonzero (48 MB),
//   1 MB of rowptr and 20 MB each of x and y for 80 MFLOP: bound by device
//   memory.  It reads each nonzero once per output column and relies on
//   L1/L2 for the reuse.
//
// Kernel 5, csr_spmm_f32_tiled: the f32 product of the mixed inner CG, whose
//   operand is (m, n) in shape and (n, m) in memory: a row of the logical x,
//   one m-float record, is contiguous.  Bound: 16 MB of values, 16 MB of
//   colidx, 1 MB of rowptr and 10 MB each of x and y (15.8 us at 3.35 TB/s)
//   for 80 MFLOP.  Design:
//   * Row tiles.  Block b owns rows [tiles[b], tiles[b+1]), a range of whole
//     rows whose entries fit `budget` entries of shared memory (the plan,
//     onehot.csr_tiles, computed once per matrix on the host).  A row longer
//     than the budget is a tile of its own, streamed in chunks of `budget`.
//   * Staging.  The block copies its tile's colidx and values into shared
//     memory with 16-byte cp.async copies from the 16-byte-aligned start of
//     its range (4-byte copies where an array does not start on 16 bytes),
//     so each byte of the matrix crosses from device memory once, not once
//     per output column.
//   * Thread map.  Thread t takes the items t, t + kThreads, ... of the
//     tile's (row, column group) pairs, column group fastest, VEC floats a
//     group: the lanes of one row gather its x records with VEC-float loads
//     (a row of x is m contiguous floats: 40 bytes at m = 10), and a warp
//     holds several rows, each a chain of independent gathers; a thread
//     issues kBatch gathers before it adds them, in order.  Any m works: the
//     column groups of a row are items like any other.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void csr_spmm_kernel(const int* __restrict__ rowptr,
                                const int* __restrict__ colidx,
                                const T* __restrict__ values, int64_t n,
                                int64_t m, const T* __restrict__ x,
                                int64_t xs_i, int64_t xs_j, T* __restrict__ y,
                                int64_t ys_i, int64_t ys_j, int j_fast) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * m) return;
  int64_t i, j;
  if (j_fast) {
    i = t / m;
    j = t - i * m;
  } else {
    j = t / n;
    i = t - j * n;
  }
  const int p1 = __ldg(rowptr + i + 1);
  const T* xj = x + j * xs_j;
  T acc = T(0);
  for (int p = __ldg(rowptr + i); p < p1; ++p)
    acc += __ldg(values + p) * xj[(int64_t)__ldg(colidx + p) * xs_i];
  y[i * ys_i + j * ys_j] = acc;
}

// ---- kernel 5 ---------------------------------------------------------------

constexpr int kThreads = 128;   // threads of a block
constexpr int kBatch = 8;       // gathers a thread issues before it adds them
// most entries a block stages: their 8 bytes each fit the 48 KB a block may
// use without opting in to more
constexpr int kMaxBudget = 48 * 1024 / 8;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory; the bytes past `src_bytes` are
// written as zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Entries [e0, e1) of colidx and values to s_col and s_val [0, e1 - e0), for
// every thread of the block to read.  copy16: e0 is a multiple of 4 and both
// arrays start on 16 bytes; entries past nnz are zero-filled.
__device__ __forceinline__ void stage(int* s_col, float* s_val,
                                      const int* __restrict__ colidx,
                                      const float* __restrict__ values,
                                      int64_t e0, int64_t e1, int64_t nnz,
                                      int copy16) {
  if (copy16) {
    for (int64_t e = e0 + 4 * threadIdx.x; e < e1; e += 4 * kThreads) {
      const int64_t left = nnz - e;
      const int bytes = 4 * (int)(left < 4 ? left : 4);
      cp_async16(s_col + (e - e0), colidx + e, bytes);
      cp_async16(s_val + (e - e0), values + e, bytes);
    }
  } else {
    for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
      cp_async4(s_col + (e - e0), colidx + e);
      cp_async4(s_val + (e - e0), values + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// VEC floats of x or of y
template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_x(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_y(float* p, const Vec<VEC>& a) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
  } else {
    p[0] = a.v[0];
  }
}

// acc += the staged entries [q0, q1) times their x records, in order.  xg
// points at the item's first column of x; a record's row stride is xs_i.
template <int VEC>
__device__ __forceinline__ void gather_row(Vec<VEC>& acc,
                                           const int* s_col,
                                           const float* s_val, int q0,
                                           int q1, const float* xg,
                                           int64_t xs_i) {
  int q = q0;
  for (; q + kBatch <= q1; q += kBatch) {
    Vec<VEC> xv[kBatch];
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      v[b] = s_val[q + b];
      xv[b] = load_x<VEC>(xg + (int64_t)s_col[q + b] * xs_i);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc.v[e] = fmaf(v[b], xv[b].v[e], acc.v[e]);
  }
  for (; q < q1; ++q) {
    const Vec<VEC> xv = load_x<VEC>(xg + (int64_t)s_col[q] * xs_i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = fmaf(s_val[q], xv.v[e], acc.v[e]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
    csr_spmm_f32_tiled(const int* __restrict__ rowptr,
                       const int* __restrict__ colidx,
                       const float* __restrict__ values, int64_t nnz,
                       const int* __restrict__ tiles, int budget, int64_t m,
                       const float* __restrict__ x, int64_t xs_i,
                       int64_t xs_j, float* __restrict__ y, int64_t ys_i,
                       int64_t ys_j, int copy16) {
  extern __shared__ __align__(16) int smem[];
  int* s_col = smem;
  float* s_val = reinterpret_cast<float*>(smem + budget);
  const int r0 = __ldg(tiles + blockIdx.x);
  const int r1 = __ldg(tiles + blockIdx.x + 1);
  const int64_t p0 = __ldg(rowptr + r0), p1 = __ldg(rowptr + r1);
  const int64_t e0 = copy16 ? (p0 & ~(int64_t)3) : p0;
  const int64_t e1 = copy16 ? ((p1 + 3) & ~(int64_t)3) : p1;
  const int groups = (int)(m / VEC);
  if (e1 - e0 <= budget) {
    stage(s_col, s_val, colidx, values, e0, e1, nnz, copy16);
    const int items = (r1 - r0) * groups;
    for (int it = threadIdx.x; it < items; it += kThreads) {
      const int a = it / groups;
      const int g = it - a * groups;
      const int64_t r = r0 + a;
      Vec<VEC> acc;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc.v[e] = 0.0f;
      gather_row<VEC>(acc, s_col, s_val, (int)(__ldg(rowptr + r) - e0),
                      (int)(__ldg(rowptr + r + 1) - e0),
                      x + (int64_t)g * VEC * xs_j, xs_i);
      store_y<VEC>(y + r * ys_i + (int64_t)g * VEC * ys_j, acc);
    }
    return;
  }
  // a tile of one row longer than the budget: its entries stream through
  // shared memory in chunks of `budget`, the sums carried across chunks
  for (int g0 = 0; g0 < groups; g0 += kThreads) {
    const int g = g0 + threadIdx.x;
    Vec<VEC> acc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = 0.0f;
    for (int64_t c = e0; c < e1; c += budget) {
      const int64_t c1 = c + budget < e1 ? c + budget : e1;
      __syncthreads();     // every thread is done with the last chunk
      stage(s_col, s_val, colidx, values, c, c1, nnz, copy16);
      if (g < groups)
        gather_row<VEC>(acc, s_col, s_val, (int)((p0 > c ? p0 : c) - c),
                        (int)((p1 < c1 ? p1 : c1) - c),
                        x + (int64_t)g * VEC * xs_j, xs_i);
    }
    if (g < groups) store_y<VEC>(y + r0 * ys_i + (int64_t)g * VEC * ys_j, acc);
  }
}

template <typename T>
int launch(const int* rowptr, const int* colidx, const T* values, int64_t n,
           int64_t m, const T* x, int64_t xs_i, int64_t xs_j, T* y,
           int64_t ys_i, int64_t ys_j, void* stream) {
  const int threads = 256;
  const int64_t blocks = (n * m + threads - 1) / threads;
  const int j_fast = ys_j <= ys_i ? 1 : 0;
  csr_spmm_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rowptr, colidx, values, n, m, x, xs_i, xs_j, y, ys_i, ys_j, j_fast);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_tiled(const int* rowptr, const int* colidx, const float* values,
                 int64_t nnz, const int* tiles, int64_t ntiles, int budget,
                 int64_t m, const float* x, int64_t xs_i, int64_t xs_j,
                 float* y, int64_t ys_i, int64_t ys_j, int copy16,
                 cudaStream_t stream) {
  const size_t smem = (size_t)budget * (sizeof(int) + sizeof(float));
  csr_spmm_f32_tiled<VEC><<<(unsigned)ntiles, kThreads, smem, stream>>>(
      rowptr, colidx, values, nnz, tiles, budget, m, x, xs_i, xs_j, y, ys_i,
      ys_j, copy16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcge_csr_spmm_f64(const void* rowptr, const void* colidx,
                                 const void* values, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 void* stream) {
  return launch<double>((const int*)rowptr, (const int*)colidx,
                        (const double*)values, n, m, (const double*)x, xs_i,
                        xs_j, (double*)y, ys_i, ys_j, stream);
}

// Kernel 5.  tiles: ntiles + 1 first rows (onehot.csr_tiles); budget:
// entries of colidx and values a block stages, a multiple of 4 up to
// kMaxBudget; vec: floats a thread gathers and stores at once (4, 2 or 1,
// dividing m); copy16: colidx and values start on 16 bytes.  The launch plan
// is onehot.csr_plan's.
extern "C" int gcge_csr_spmm_f32(const void* rowptr, const void* colidx,
                                 const void* values, int64_t nnz,
                                 const void* tiles, int64_t ntiles,
                                 int64_t budget, int64_t m, const void* x,
                                 int64_t xs_i, int64_t xs_j, void* y,
                                 int64_t ys_i, int64_t ys_j, int64_t vec,
                                 int64_t copy16, void* stream) {
  if (budget <= 0 || budget % 4 != 0 || budget > kMaxBudget || m % vec != 0)
    return (int)cudaErrorInvalidValue;
  const auto fn = vec == 4   ? launch_tiled<4>
                  : vec == 2 ? launch_tiled<2>
                             : launch_tiled<1>;
  return fn((const int*)rowptr, (const int*)colidx, (const float*)values,
            nnz, (const int*)tiles, ntiles, (int)budget, m, (const float*)x,
            xs_i, xs_j, (float*)y, ys_i, ys_j, (int)copy16,
            (cudaStream_t)stream);
}
