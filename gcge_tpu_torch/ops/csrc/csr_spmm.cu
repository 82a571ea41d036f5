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
// Kernel 5, csr_spmm_f32_tiled: the f32 product of the mixed inner CG, whose
//   operand is (m, n) in shape and (n, m) in memory: a row of the logical x,
//   one m-float record, is contiguous.  Bound: 16 MB of values, 16 MB of
//   colidx, 1 MB of rowptr and 10 MB each of x and y (15.8 us at 3.35 TB/s)
//   for 80 MFLOP.
//
// Kernel 6, csr_spmm_f64_tiled: every f64 application of a CSR operator in a
//   solve: the W coupling of each Rayleigh-Ritz step on the column view
//   V[:, size_x + bs:] (rows 120 doubles apart), the residual window (an odd
//   column offset: rows 8-byte aligned only), the initial Rayleigh-Ritz at
//   m = 100 and the inner solve's f64 refresh.  At the irregular slice's
//   shape (n = 250,047, nnz = 4,004,065, m = 10) one call must move 12 B per
//   nonzero (48 MB), 1 MB of rowptr and 20 MB each of x and y (26.6 us at
//   3.35 TB/s) for 80 MFLOP: bound by device memory.
//
// Both kernels are one design (csr_spmm_tiled), in T = float and double:
//   * Row tiles.  Block b owns rows [tiles[b], tiles[b+1]), a range of whole
//     rows whose entries fit `budget` entries of shared memory (the plan,
//     onehot.csr_tiles, computed once per matrix on the host; it depends on
//     rowptr alone, so one plan serves both kernels: 1,024 entries are 8 KB
//     in f32 and 12 KB in f64).  A row longer than the budget is a tile of
//     its own, streamed in chunks of `budget`.
//   * Staging.  The block copies its tile's colidx and values into shared
//     memory with 16-byte cp.async copies from the 16-byte-aligned start of
//     its range (a multiple of 4 entries: 16 bytes of colidx, 16 or 32 of
//     values; one-element copies where an array does not start on 16 bytes),
//     so each byte of the matrix crosses from device memory once, not once
//     per output column.
//   * Thread map.  Thread t takes the items t, t + kThreads, ... of the
//     tile's (row, column group) pairs, VEC elements (16 bytes or one) a
//     group: the lanes of one row gather its x records with VEC-element
//     loads (a row of x is m contiguous elements: 40 bytes in f32, 80 in
//     f64 at m = 10), and a warp holds several rows, each a chain of
//     independent gathers; a thread issues kBatch gathers before it adds
//     them, in order.  The column group runs fastest, unless y's rows are
//     adjacent (a transposed layout): then the row does, so that
//     neighbouring threads store neighbouring elements and gather from
//     neighbouring rows' columns.  Any m works: the column groups of a row
//     are items like any other.
//   What holds kernel 6 at the solve's operand (found on the H100 by leaving
//   parts out): the gathers of x; the tile's staging and the stores alone
//   take well under half its time.  Within a tile of the Delaunay matrix
//   only about a third of the gathered records are distinct, but staging
//   each distinct record once in shared memory (a plan of local indices)
//   measured no faster: L1 already serves the repeats.  Nor were 4 or 16
//   gathers in flight, 512 threads, or other tile budgets.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads of a block: 128 in f32, 256 in f64 (measured the faster of 128,
// 256 and 512 for each type on the H100)
template <typename T>
constexpr int kThreads = sizeof(T) == 8 ? 256 : 128;
constexpr int kBatch = 8;       // gathers a thread issues before it adds them

// most entries a block stages: colidx and values fit the 48 KB a block may
// use without opting in to more
template <typename T>
constexpr int kMaxBudget = 48 * 1024 / (int)(sizeof(int) + sizeof(T));

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

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
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
// arrays start on 16 bytes; entries past nnz are zero-filled or not copied.
template <typename T>
__device__ __forceinline__ void stage(int* s_col, T* s_val,
                                      const int* __restrict__ colidx,
                                      const T* __restrict__ values,
                                      int64_t e0, int64_t e1, int64_t nnz,
                                      int copy16) {
  if (copy16) {
    for (int64_t e = e0 + 4 * threadIdx.x; e < e1; e += 4 * kThreads<T>) {
      const int64_t left = nnz - e;
      const int have = (int)(left < 4 ? left : 4);
      cp_async16(s_col + (e - e0), colidx + e, 4 * have);
      if constexpr (sizeof(T) == 4) {
        cp_async16(s_val + (e - e0), values + e, 4 * have);
      } else {
        cp_async16(s_val + (e - e0), values + e, 8 * (have < 2 ? have : 2));
        if (have > 2)
          cp_async16(s_val + (e - e0) + 2, values + e + 2, 8 * (have - 2));
      }
    }
  } else {
    for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads<T>) {
      cp_async4(s_col + (e - e0), colidx + e);
      if constexpr (sizeof(T) == 4)
        cp_async4(s_val + (e - e0), values + e);
      else
        cp_async8(s_val + (e - e0), values + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// VEC elements of x or of y
template <typename T, int VEC>
struct Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_x(const T* p) {
  Vec<T, VEC> r;
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
    r.v[2] = t.z;
    r.v[3] = t.w;
  } else if constexpr (sizeof(T) == 4 && VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else if constexpr (sizeof(T) == 8 && VEC == 2) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else {
    r.v[0] = __ldg(p);
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store_y(T* p, const Vec<T, VEC>& a) {
  if constexpr (sizeof(T) == 4 && VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
  } else if constexpr (sizeof(T) == 4 && VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a.v[0], a.v[1]);
  } else if constexpr (sizeof(T) == 8 && VEC == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(a.v[0], a.v[1]);
  } else {
    p[0] = a.v[0];
  }
}

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// acc += the staged entries [q0, q1) times their x records, in order.  xg
// points at the item's first column of x; a record's row stride is xs_i.
template <typename T, int VEC>
__device__ __forceinline__ void gather_row(Vec<T, VEC>& acc, const int* s_col,
                                           const T* s_val, int q0, int q1,
                                           const T* xg, int64_t xs_i) {
  int q = q0;
  for (; q + kBatch <= q1; q += kBatch) {
    Vec<T, VEC> xv[kBatch];
    T v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      v[b] = s_val[q + b];
      xv[b] = load_x<T, VEC>(xg + (int64_t)s_col[q + b] * xs_i);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc.v[e] = fma_t(v[b], xv[b].v[e], acc.v[e]);
  }
  for (; q < q1; ++q) {
    const Vec<T, VEC> xv = load_x<T, VEC>(xg + (int64_t)s_col[q] * xs_i);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = fma_t(s_val[q], xv.v[e], acc.v[e]);
  }
}

// The body of both kernels, on block blockIdx.x's row tile.
template <typename T, int VEC>
__device__ __forceinline__ void csr_spmm_tiled(
    const int* __restrict__ rowptr, const int* __restrict__ colidx,
    const T* __restrict__ values, int64_t nnz, const int* __restrict__ tiles,
    int budget, int64_t m, const T* __restrict__ x, int64_t xs_i,
    int64_t xs_j, T* __restrict__ y, int64_t ys_i, int64_t ys_j, int copy16,
    int row_fast, int* smem) {
  int* s_col = smem;
  // the values after the column indices, on 16 bytes (budget is a multiple
  // of 4)
  T* s_val = reinterpret_cast<T*>(smem + budget);
  const int r0 = __ldg(tiles + blockIdx.x);
  const int r1 = __ldg(tiles + blockIdx.x + 1);
  const int64_t p0 = __ldg(rowptr + r0), p1 = __ldg(rowptr + r1);
  const int64_t e0 = copy16 ? (p0 & ~(int64_t)3) : p0;
  const int64_t e1 = copy16 ? ((p1 + 3) & ~(int64_t)3) : p1;
  const int groups = (int)(m / VEC);
  if (e1 - e0 <= budget) {
    stage<T>(s_col, s_val, colidx, values, e0, e1, nnz, copy16);
    const int nrows = r1 - r0;
    const int items = nrows * groups;
    for (int it = threadIdx.x; it < items; it += kThreads<T>) {
      int a, g;
      if (row_fast) {
        g = it / nrows;
        a = it - g * nrows;
      } else {
        a = it / groups;
        g = it - a * groups;
      }
      const int64_t r = r0 + a;
      Vec<T, VEC> acc;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc.v[e] = T(0);
      gather_row<T, VEC>(acc, s_col, s_val, (int)(__ldg(rowptr + r) - e0),
                         (int)(__ldg(rowptr + r + 1) - e0),
                         x + (int64_t)g * VEC * xs_j, xs_i);
      store_y<T, VEC>(y + r * ys_i + (int64_t)g * VEC * ys_j, acc);
    }
    return;
  }
  // a tile of one row longer than the budget: its entries stream through
  // shared memory in chunks of `budget`, the sums carried across chunks
  for (int g0 = 0; g0 < groups; g0 += kThreads<T>) {
    const int g = g0 + threadIdx.x;
    Vec<T, VEC> acc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc.v[e] = T(0);
    for (int64_t c = e0; c < e1; c += budget) {
      const int64_t c1 = c + budget < e1 ? c + budget : e1;
      __syncthreads();     // every thread is done with the last chunk
      stage<T>(s_col, s_val, colidx, values, c, c1, nnz, copy16);
      if (g < groups)
        gather_row<T, VEC>(acc, s_col, s_val, (int)((p0 > c ? p0 : c) - c),
                           (int)((p1 < c1 ? p1 : c1) - c),
                           x + (int64_t)g * VEC * xs_j, xs_i);
    }
    if (g < groups)
      store_y<T, VEC>(y + r0 * ys_i + (int64_t)g * VEC * ys_j, acc);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads<float>)
    csr_spmm_f32_tiled(const int* __restrict__ rowptr,
                       const int* __restrict__ colidx,
                       const float* __restrict__ values, int64_t nnz,
                       const int* __restrict__ tiles, int budget, int64_t m,
                       const float* __restrict__ x, int64_t xs_i,
                       int64_t xs_j, float* __restrict__ y, int64_t ys_i,
                       int64_t ys_j, int copy16, int row_fast) {
  extern __shared__ __align__(16) int smem_f[];
  csr_spmm_tiled<float, VEC>(rowptr, colidx, values, nnz, tiles, budget, m, x,
                             xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast,
                             smem_f);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads<double>)
    csr_spmm_f64_tiled(const int* __restrict__ rowptr,
                       const int* __restrict__ colidx,
                       const double* __restrict__ values, int64_t nnz,
                       const int* __restrict__ tiles, int budget, int64_t m,
                       const double* __restrict__ x, int64_t xs_i,
                       int64_t xs_j, double* __restrict__ y, int64_t ys_i,
                       int64_t ys_j, int copy16, int row_fast) {
  extern __shared__ __align__(16) int smem_d[];
  csr_spmm_tiled<double, VEC>(rowptr, colidx, values, nnz, tiles, budget, m,
                              x, xs_i, xs_j, y, ys_i, ys_j, copy16, row_fast,
                              smem_d);
}

template <typename T, int VEC>
int launch_tiled(const int* rowptr, const int* colidx, const T* values,
                 int64_t nnz, const int* tiles, int64_t ntiles, int budget,
                 int64_t m, const T* x, int64_t xs_i, int64_t xs_j, T* y,
                 int64_t ys_i, int64_t ys_j, int copy16, int row_fast,
                 cudaStream_t stream) {
  const size_t smem = (size_t)budget * (sizeof(int) + sizeof(T));
  if constexpr (sizeof(T) == 8)
    csr_spmm_f64_tiled<VEC><<<(unsigned)ntiles, kThreads<T>, smem, stream>>>(
        rowptr, colidx, values, nnz, tiles, budget, m, x, xs_i, xs_j, y, ys_i,
        ys_j, copy16, row_fast);
  else
    csr_spmm_f32_tiled<VEC><<<(unsigned)ntiles, kThreads<T>, smem, stream>>>(
        rowptr, colidx, values, nnz, tiles, budget, m, x, xs_i, xs_j, y, ys_i,
        ys_j, copy16, row_fast);
  return (int)cudaGetLastError();
}

// a plan the kernels cannot take: a budget that is not a positive multiple
// of 4 up to kMaxBudget, vec not one of T's widths or not dividing m
template <typename T>
bool bad_plan(int64_t budget, int64_t m, int64_t vec) {
  const bool vec_ok = vec == 1 || vec == 2 || (sizeof(T) == 4 && vec == 4);
  return budget <= 0 || budget % 4 != 0 || budget > kMaxBudget<T> ||
         !vec_ok || m % vec != 0;
}

}  // namespace

// Kernels 5 (f32) and 6 (f64).  tiles: ntiles + 1 first rows
// (onehot.csr_tiles); budget: entries of colidx and values a block stages,
// a multiple of 4 up to kMaxBudget; vec: elements a thread gathers and
// stores at once (f32: 4, 2 or 1; f64: 2 or 1; dividing m); copy16: colidx
// and values start on 16 bytes; row_fast: the items' rows run fastest (y's
// rows adjacent).  The launch plan is onehot.csr_plan's and the wrapper's.
extern "C" int gcge_csr_spmm_f32(const void* rowptr, const void* colidx,
                                 const void* values, int64_t nnz,
                                 const void* tiles, int64_t ntiles,
                                 int64_t budget, int64_t m, const void* x,
                                 int64_t xs_i, int64_t xs_j, void* y,
                                 int64_t ys_i, int64_t ys_j, int64_t vec,
                                 int64_t copy16, int64_t row_fast,
                                 void* stream) {
  if (bad_plan<float>(budget, m, vec)) return (int)cudaErrorInvalidValue;
  const auto fn = vec == 4   ? launch_tiled<float, 4>
                  : vec == 2 ? launch_tiled<float, 2>
                             : launch_tiled<float, 1>;
  return fn((const int*)rowptr, (const int*)colidx, (const float*)values,
            nnz, (const int*)tiles, ntiles, (int)budget, m, (const float*)x,
            xs_i, xs_j, (float*)y, ys_i, ys_j, (int)copy16, (int)row_fast,
            (cudaStream_t)stream);
}

extern "C" int gcge_csr_spmm_f64(const void* rowptr, const void* colidx,
                                 const void* values, int64_t nnz,
                                 const void* tiles, int64_t ntiles,
                                 int64_t budget, int64_t m, const void* x,
                                 int64_t xs_i, int64_t xs_j, void* y,
                                 int64_t ys_i, int64_t ys_j, int64_t vec,
                                 int64_t copy16, int64_t row_fast,
                                 void* stream) {
  if (bad_plan<double>(budget, m, vec)) return (int)cudaErrorInvalidValue;
  const auto fn = vec == 2 ? launch_tiled<double, 2>
                           : launch_tiled<double, 1>;
  return fn((const int*)rowptr, (const int*)colidx, (const double*)values,
            nnz, (const int*)tiles, ntiles, (int)budget, m, (const double*)x,
            xs_i, xs_j, (double*)y, ys_i, ys_j, (int)copy16, (int)row_fast,
            (cudaStream_t)stream);
}
