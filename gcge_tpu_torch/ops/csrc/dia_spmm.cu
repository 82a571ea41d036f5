// DIA sparse matrix times multivector on Hopper (kernels 1 and 2 of the port).
//
//   y[i, j] = sum_d values[d, i] * x[hl + i + off_d, j]
//                                           (0 <= hl + i + off_d < nx)
//
// x is a logical (nx, m) matrix, nx = n + hl + hr, and y a logical (n, m)
// one, both given by 2-D strides, so the same entry points serve the
// row-major (n, m) layout of DiaOperator.matvec and the transposed (m, n)
// layout of matvec_t, views included, without a copy.  hl = hr = 0 is the
// square product; otherwise x is a halo window, a rank's rows between hl rows
// of its left neighbour and hr of its right one (parallel/dist_ops.py), the
// contract of the TPU kernels' `hl` (spmm_pallas.py:68-94, :207-234).  In
// both kernels the sum runs in T, in the order of the offsets, as both TPU
// paths do, one fused multiply-add a term, terms outside [0, nx) skipped,
// with no atomics: two launches on the same inputs give the same bits.
//
// Kernel 1, dia_spmm_f64_staged: replaces gcge_tpu/ops/spmm_pallas.py:
//   _dia_spmm_t_df64 (f64 quality from f32 hi/lo planes, because the TPU has
//   no f64; Hopper has native f64).  Every f64 application of A in a solve:
//   the W coupling of each Rayleigh-Ritz step on the column view
//   V[:, size_x + bs:] (rows 120 doubles apart at the headline), the initial
//   Rayleigh-Ritz on V[:, :size_x] (m = 100), the residual window
//   ritz[:, c0:c0 + cw] (c0 may be odd: rows 8-byte aligned only) and the
//   inner solve's f64 refresh on a contiguous (n, bs).  Bound: at the
//   headline shape (27 diagonals, n = 157,464, m = 10) one call must move
//   34 MB of values and 12.6 MB each of x and y (17.7 us at 3.35 TB/s) for
//   85 MFLOP: bound by device memory.
//
// Kernel 2, dia_spmm_f32_staged: replaces spmm_pallas.py:_dia_spmm_t (the f32
//   kernel of the mixed-precision inner CG, which stages three lane tiles of
//   x in VMEM and slices a shifted window per diagonal).  Its operand is the
//   CG's: (m, n) in shape, (n, m) in memory, so a row of the logical x, one
//   m-float record, is contiguous.  Bound: at the headline shape one call
//   must move 17.0 MB of values and 6.3 MB each of x and y (8.8 us at
//   3.35 TB/s) for 85 MFLOP.
//
// Both kernels are one design (dia_spmm_staged), in T = double and float:
//   * A block owns kRows consecutive rows and a tile of up to kItems VEC
//     columns (all m = 10 of the CG and of the W coupling; m = 100 in ten
//     tiles, in kernel 1 the tiles of one row block next to each other in
//     the grid, so that the nine blocks after the first find its value rows
//     in L2).  Thread t holds the items t, t + kRows, ... of the tile's
//     (row, column group) pairs, VEC elements a group, and keeps their sums
//     in registers until y is written once.  The column group runs fastest,
//     unless, in kernel 1, y's rows are adjacent (a transposed layout): then
//     the row does, so that neighbouring threads store neighbouring
//     elements.
//   * Offsets that follow each other (o, o + 1, ..., up to kRun of them; the
//     27-point stencil has nine runs of three) form a run.  The rows
//     [i0 + o, i0 + o + kRows + k - 1) of x serve a whole run of k.  A stage
//     holds that window and the run's k value rows values[d, i0:i0+kRows]:
//     the values are read once a row, x once a run instead of once a
//     diagonal.  Both are copied into shared memory with cp.async:
//       f32 window: one flat range in 16-byte pieces where x's rows are
//         contiguous and adjacent (the CG's operand), else 4-byte copies;
//       f64 window: each window row's segment of the tile in 16-byte pieces
//         where every segment starts on 16 bytes (x's rows an even number of
//         doubles apart and x on 16 bytes: the column views of V at an even
//         offset, a contiguous (n, m) with m even), a last piece of 8 bytes
//         zero-filled past the segment; else 8-byte copies (an odd column
//         offset, a transposed layout), neighbouring threads on the
//         dimension of x whose stride is 1.  A window row takes ld elements
//         of shared memory (the tile's width, even in f64), so that every
//         row starts on 16 bytes;
//       values: 16-byte pieces where n is a multiple of 16 bytes' worth of
//         elements and values starts on 16 bytes, else one element a copy.
//   * The stages form a ring of kStages (two: deeper rings measured no
//     faster on the H100, and take shared memory from other blocks): the
//     next run's copies are in flight while a run's multiply-adds read
//     shared memory, and no load waits inside the multiply-adds.  The loop
//     over a run's terms checks no bounds where every row of the block and
//     every term lies inside the matrix, all but the blocks at its ends.
//   * Rows of x outside [0, nx) are never read and their terms are skipped.
//     The halo window moves the base of a run's window by hl rows and its
//     bounds to [0, nx); with hl = hr = 0 the code is the square product's.
//   What holds kernel 1 at the solve's operand (found on the H100 by
//   leaving parts out): the window copies, x staged once a run, nine times
//   a call for the 27-point stencil, from L2; they cost more than the value
//   rows and the multiply-adds together.  Persistent blocks, a third ring
//   stage, blocks of 64 rows, fewer registers, and one window for a whole
//   plane of the stencil (three runs: 39 % fewer window bytes, but a 59 KB
//   ring and three blocks an SM) each measured no faster at m = 10.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;              // rows of a block = its threads
constexpr int kRun = 4;                 // most offsets a window serves
constexpr int kItems = 5;               // column groups of a tile
constexpr int kStages = 2;              // runs in the ring
constexpr int kWin = kRows + kRun - 1;  // rows of a window

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

// one element of T
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) == 8)
    cp_async8(dst, src);
  else
    cp_async4(dst, src);
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elements of T in 16 bytes
template <typename T>
constexpr int kPer16 = 16 / (int)sizeof(T);

// elements a window takes: kWin rows of ld, and for f32 8 floats of
// alignment slack for the flat copy, rounded to 16 bytes; a stage adds kRun
// value rows
template <typename T>
__host__ __device__ constexpr int window_elems(int ld) {
  return (kWin * ld + (sizeof(T) == 4 ? 8 : 0) + kPer16<T> - 1) /
         kPer16<T> * kPer16<T>;
}

template <typename T>
__host__ __device__ constexpr int stage_elems(int ld) {
  return window_elems<T>(ld) + kRun * kRows;
}

// the widest column tile (kItems groups of 16 bytes) fits the 48 KB a block
// may use without opting in to more
static_assert(kStages * sizeof(float) * stage_elems<float>(4 * kItems) <=
                  48 * 1024,
              "the f32 ring does not fit 48 KB of shared memory");
static_assert(kStages * sizeof(double) * stage_elems<double>(2 * kItems) <=
                  48 * 1024,
              "the f64 ring does not fit 48 KB of shared memory");

// the length of the run of offsets that starts at d0
__device__ __forceinline__ int run_length(const int* __restrict__ offsets,
                                          int ndiag, int d0) {
  const int o = __ldg(offsets + d0);
  int k = 1;
  while (k < kRun && d0 + k < ndiag && __ldg(offsets + d0 + k) == o + k) ++k;
  return k;
}

// f32: with `copy16` (flat), x's rows are contiguous and adjacent (xs_j = 1,
// xs_i = m = mt) and x starts on 16 bytes, so the window is one range of
// floats, copied in 16-byte pieces from its 16-byte-aligned start, and its
// first element lands at s + window_shift(w0, m)
__device__ __forceinline__ int window_shift(int64_t w0, int64_t m) {
  return (int)((w0 * m) & 3);
}

// Issue the copies of the window of rows [w0, w0 + rows) and columns
// [c0, c0 + mt) of x (n rows here: the caller passes nx) into `s`, row a at
// s + a * ld (f32 flat: see window_shift).  Rows outside [0, n) are not
// copied.
__device__ __forceinline__ void stage_window(float* s, const float* x,
                                             int64_t n, int64_t m,
                                             int64_t xs_i, int64_t xs_j,
                                             int64_t w0, int rows, int c0,
                                             int mt, int ld, int copy16) {
  if (copy16) {
    const int64_t first = w0 * m;                 // may be negative
    const int64_t base = first & ~(int64_t)3;     // floor to 4 floats
    const int64_t lo = base > 0 ? base : 0;
    const int64_t total = n * m;
    int64_t hi = first + (int64_t)rows * m;
    if (hi > total) hi = total;
    for (int64_t e = lo + 4 * threadIdx.x; e < hi; e += 4 * kRows) {
      const int64_t left = total - e;
      cp_async16(s + (e - base), x + e, 4 * (int)(left < 4 ? left : 4));
    }
    return;
  }
  for (int el = threadIdx.x; el < rows * mt; el += kRows) {
    const int a = el / mt;
    const int64_t r = w0 + a;
    if (r >= 0 && r < n)
      cp_async4(s + el, x + r * xs_i + (int64_t)(c0 + el - a * mt) * xs_j);
  }
}

// f64: with `copy16`, every row segment of the window starts on 16 bytes
__device__ __forceinline__ void stage_window(double* s, const double* x,
                                             int64_t n, int64_t, int64_t xs_i,
                                             int64_t xs_j, int64_t w0,
                                             int rows, int c0, int mt, int ld,
                                             int copy16) {
  // a window row's segment is at most 2 kItems doubles: 8 slots of 16 bytes
  // or 16 of 8 a row, so that a slot's row and column take a shift and a
  // mask where a division by mt measured slower
  static_assert(2 * kItems <= 16, "a row segment exceeds its slots");
  if (copy16) {
    for (int el = threadIdx.x; el < rows * 8; el += kRows) {
      const int a = el >> 3;
      const int col = 2 * (el & 7);
      const int64_t r = w0 + a;
      if (col < mt && r >= 0 && r < n)
        cp_async16(s + a * ld + col, x + r * xs_i + c0 + col,
                   mt - col >= 2 ? 16 : 8);
    }
  } else if (xs_i == 1) {      // rows adjacent: threads along a column
    for (int el = threadIdx.x; el < rows * mt; el += kRows) {
      const int col = el / rows;
      const int a = el - col * rows;
      const int64_t r = w0 + a;
      if (r >= 0 && r < n)
        cp_async8(s + a * ld + col, x + r + (int64_t)(c0 + col) * xs_j);
    }
  } else {
    for (int el = threadIdx.x; el < rows * 16; el += kRows) {
      const int a = el >> 4;
      const int col = el & 15;
      const int64_t r = w0 + a;
      if (col < mt && r >= 0 && r < n)
        cp_async8(s + a * ld + col, x + r * xs_i + (int64_t)(c0 + col) * xs_j);
    }
  }
}

// Issue the copies of values[d0 + e, i0 : i0 + kRows) for e < k into `s`,
// row e at s + e * kRows; columns past n are not read.  vec16: n is a
// multiple of kPer16<T> and values starts on 16 bytes.
template <typename T>
__device__ __forceinline__ void stage_values(T* s, const T* __restrict__ values,
                                             int64_t n, int d0, int k,
                                             int64_t i0, int vec16) {
  constexpr int P = kPer16<T>;
  if (vec16) {
    for (int c = threadIdx.x; c < k * (kRows / P); c += kRows) {
      const int e = c / (kRows / P);
      const int64_t i = i0 + P * (c - e * (kRows / P));
      if (i < n)
        cp_async16(s + e * kRows + (i - i0),
                   values + (int64_t)(d0 + e) * n + i, 16);
    }
    return;
  }
  for (int c = threadIdx.x; c < k * kRows; c += kRows) {
    const int e = c / kRows;
    const int64_t i = i0 + (c - e * kRows);
    if (i < n) cp_async_elem<T>(s + c, values + (int64_t)(d0 + e) * n + i);
  }
}

// VEC elements of a window or of y, and their fused multiply-adds
template <typename T, int VEC>
struct Vec {
  T v[VEC];
};

template <int VEC>
__device__ __forceinline__ void fma_vec(Vec<float, VEC>& acc, float a,
                                        const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    acc.v[0] = fmaf(a, t.x, acc.v[0]);
    acc.v[1] = fmaf(a, t.y, acc.v[1]);
    acc.v[2] = fmaf(a, t.z, acc.v[2]);
    acc.v[3] = fmaf(a, t.w, acc.v[3]);
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    acc.v[0] = fmaf(a, t.x, acc.v[0]);
    acc.v[1] = fmaf(a, t.y, acc.v[1]);
  } else {
    acc.v[0] = fmaf(a, p[0], acc.v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void fma_vec(Vec<double, VEC>& acc, double a,
                                        const double* p) {
  if constexpr (VEC == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    acc.v[0] = fma(a, t.x, acc.v[0]);
    acc.v[1] = fma(a, t.y, acc.v[1]);
  } else {
    acc.v[0] = fma(a, p[0], acc.v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const Vec<float, VEC>& acc) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) =
        make_float4(acc.v[0], acc.v[1], acc.v[2], acc.v[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(acc.v[0], acc.v[1]);
  } else {
    p[0] = acc.v[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(double* p,
                                          const Vec<double, VEC>& acc) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(acc.v[0], acc.v[1]);
  } else {
    p[0] = acc.v[0];
  }
}

// Where kernel 1 and kernel 2 differ beyond the copies: kernel 1 puts the
// column tiles of a row block next to each other in a 1-D grid (so that the
// tiles after the first find the value rows in L2) and takes row-fast items;
// kernel 2 puts the tiles on grid y and runs the column group fastest, which
// measured faster for it.
template <typename T>
constexpr bool kTilesAdjacent = sizeof(T) == 8;

// The body of both kernels.  Block b takes column tile b % ntiles of row
// block b / ntiles (f64), or tile blockIdx.y of row block blockIdx.x (f32).
// ld: elements a window row takes in shared memory
// (f32: the tile's width; f64: that rounded up to even).
template <typename T, int VEC>
__device__ __forceinline__ void dia_spmm_staged(
    const T* __restrict__ values, const int* __restrict__ offsets, int ndiag,
    int64_t n, int64_t m, const T* __restrict__ x, int64_t hl, int64_t nx,
    int64_t xs_i, int64_t xs_j, T* __restrict__ y, int64_t ys_i, int64_t ys_j,
    int col_tile, int ld, int copy16, int vec16, int row_fast, T* smem) {
  const int ntiles = (int)((m + col_tile - 1) / col_tile);
  const int tile =
      kTilesAdjacent<T> ? (int)(blockIdx.x % ntiles) : (int)blockIdx.y;
  const int slot = stage_elems<T>(ld);
  const int win = window_elems<T>(ld);
  const int64_t i0 =
      (int64_t)(kTilesAdjacent<T> ? blockIdx.x / ntiles : blockIdx.x) * kRows;
  const int c0 = tile * col_tile;
  const int mt = (int)(m - c0 < col_tile ? m - c0 : col_tile);
  const int groups = mt / VEC;
  const int mld = sizeof(T) == 4 ? mt : ld;   // window row stride in use
  const bool flat = sizeof(T) == 4 && copy16;

  // the thread's items: row a_k[k] of the block; xo_k[k], the offset of its
  // column group in a window row
  int a_k[kItems], xo_k[kItems];
  Vec<T, VEC> acc[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int item = threadIdx.x + k * kRows;
    int g;
    if (kTilesAdjacent<T> && row_fast) {
      a_k[k] = threadIdx.x;
      g = k;
    } else {
      a_k[k] = item / groups;
      g = item - a_k[k] * groups;
    }
    xo_k[k] = a_k[k] * mld + g * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k].v[e] = T(0);
  }
  const int rows = (int)(n - i0 < kRows ? n - i0 : kRows);

  // the ring: run r lives in stage r % kStages; every step commits one copy
  // group (empty once the runs are all issued)
  int d_issue = 0;
  auto issue = [&](int stage) {
    if (d_issue < ndiag) {
      const int k = run_length(offsets, ndiag, d_issue);
      T* s = smem + stage * slot;
      stage_window(s, x, nx, m, xs_i, xs_j,
                   hl + i0 + __ldg(offsets + d_issue), kRows + k - 1, c0, mt,
                   mld, copy16);
      stage_values<T>(s + win, values, n, d_issue, k, i0, vec16);
      d_issue += k;
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue(st);
  int stage = 0;
  for (int d0 = 0; d0 < ndiag;) {
    issue(stage == 0 ? kStages - 1 : stage - 1);
    cp_wait<kStages - 1>();
    __syncthreads();
    const int k = run_length(offsets, ndiag, d0);
    const int o = __ldg(offsets + d0);
    const T* s =
        smem + stage * slot + (flat ? window_shift(hl + i0 + o, m) : 0);
    const T* sv = smem + stage * slot + win;
    // inside x, every row's every term is in range: no checks
    const bool inside = rows == kRows && hl + i0 + o >= 0 &&
                        hl + i0 + o + kRows + k - 1 <= nx;
    if (inside) {
      for (int e = 0; e < k; ++e) {
#pragma unroll
        for (int kk = 0; kk < kItems; ++kk)
          if (kk < groups)
            fma_vec<VEC>(acc[kk], sv[e * kRows + a_k[kk]],
                         s + e * mld + xo_k[kk]);
      }
    } else {
      for (int e = 0; e < k; ++e) {
#pragma unroll
        for (int kk = 0; kk < kItems; ++kk) {
          const int64_t c = hl + i0 + a_k[kk] + o + e;
          if (kk < groups && a_k[kk] < rows && c >= 0 && c < nx)
            fma_vec<VEC>(acc[kk], sv[e * kRows + a_k[kk]],
                         s + e * mld + xo_k[kk]);
        }
      }
    }
    __syncthreads();     // this stage is refilled on the next step
    d0 += k;
    stage = stage == kStages - 1 ? 0 : stage + 1;
  }

#pragma unroll
  for (int kk = 0; kk < kItems; ++kk)
    if (kk < groups && a_k[kk] < rows)
      store_vec<VEC>(y + (i0 + a_k[kk]) * ys_i +
                         (int64_t)(c0 + xo_k[kk] - a_k[kk] * mld) * ys_j,
                     acc[kk]);
}

template <int VEC>
__global__ void __launch_bounds__(kRows)
    dia_spmm_f64_staged(const double* __restrict__ values,
                        const int* __restrict__ offsets, int ndiag, int64_t n,
                        int64_t m, const double* __restrict__ x, int64_t hl,
                        int64_t nx, int64_t xs_i, int64_t xs_j,
                        double* __restrict__ y, int64_t ys_i, int64_t ys_j,
                        int col_tile, int ld, int copy16, int vec16,
                        int row_fast) {
  extern __shared__ __align__(16) double smem_d[];
  dia_spmm_staged<double, VEC>(values, offsets, ndiag, n, m, x, hl, nx, xs_i,
                               xs_j, y, ys_i, ys_j, col_tile, ld, copy16,
                               vec16, row_fast, smem_d);
}

template <int VEC>
__global__ void __launch_bounds__(kRows)
    dia_spmm_f32_staged(const float* __restrict__ values,
                        const int* __restrict__ offsets, int ndiag, int64_t n,
                        int64_t m, const float* __restrict__ x, int64_t hl,
                        int64_t nx, int64_t xs_i, int64_t xs_j,
                        float* __restrict__ y, int64_t ys_i, int64_t ys_j,
                        int col_tile, int ld, int copy16, int vec16,
                        int row_fast) {
  extern __shared__ __align__(16) float smem_f[];
  dia_spmm_staged<float, VEC>(values, offsets, ndiag, n, m, x, hl, nx, xs_i,
                              xs_j, y, ys_i, ys_j, col_tile, ld, copy16,
                              vec16, row_fast, smem_f);
}

template <typename T, int VEC>
int launch_staged(const T* values, const int* offsets, int ndiag, int64_t n,
                  int64_t m, const T* x, int64_t hl, int64_t nx, int64_t xs_i,
                  int64_t xs_j, T* y,
                  int64_t ys_i, int64_t ys_j, int col_tile, int copy16,
                  int vec16, int row_fast, cudaStream_t stream) {
  const int64_t row_blocks = (n + kRows - 1) / kRows;
  const int64_t ntiles = (m + col_tile - 1) / col_tile;
  if (row_blocks * ntiles > 0x7fffffff ||
      (!kTilesAdjacent<T> && ntiles > 0xffff))
    return (int)cudaErrorInvalidValue;
  const dim3 grid = kTilesAdjacent<T>
                        ? dim3((unsigned)(row_blocks * ntiles))
                        : dim3((unsigned)row_blocks, (unsigned)ntiles);
  // a window row's elements: the tile's width, even in f64 (16 bytes)
  const int ld = sizeof(T) == 8 ? (col_tile + 1) / 2 * 2 : col_tile;
  const size_t smem = kStages * sizeof(T) * stage_elems<T>(ld);
  if constexpr (sizeof(T) == 8)
    dia_spmm_f64_staged<VEC><<<grid, kRows, smem, stream>>>(
        values, offsets, ndiag, n, m, x, hl, nx, xs_i, xs_j, y, ys_i, ys_j,
        col_tile, ld, copy16, vec16, row_fast);
  else
    dia_spmm_f32_staged<VEC><<<grid, kRows, smem, stream>>>(
        values, offsets, ndiag, n, m, x, hl, nx, xs_i, xs_j, y, ys_i, ys_j,
        col_tile, ld, copy16, vec16, row_fast);
  return (int)cudaGetLastError();
}

// a plan the kernels cannot take: vec not one of T's widths, a column tile
// that is not a positive multiple of vec up to kItems vec, vec not dividing
// m, row_fast with vec > 1
template <typename T>
bool bad_plan(int64_t m, int64_t vec, int64_t col_tile, int64_t row_fast) {
  const bool vec_ok = vec == 1 || vec == 2 || (sizeof(T) == 4 && vec == 4);
  return !vec_ok || col_tile <= 0 || col_tile > kItems * vec ||
         col_tile % vec != 0 || m % vec != 0 || (row_fast && vec != 1);
}

}  // namespace

// Kernel 1 (f64) and kernel 2 (f32).  hl, nx: the halo window (x has nx =
// n + hl + hr rows; hl = 0, nx = n: the square product).  vec: elements a
// thread reads from a
// window and writes to y at once (f64: 2 or 1; f32: 4, 2 or 1); col_tile:
// columns a block holds, at most kItems vec; copy16: the window's 16-byte
// copy (f32: one flat range; f64: 16-byte-aligned row segments, see
// stage_window); vec16: see stage_values; row_fast: a thread's items are one
// row's column groups (y's rows adjacent, vec 1).  The launch plan is
// spmm.dia_plan's.
extern "C" int gcge_dia_spmm_f64(const void* values, const void* offsets,
                                 int64_t ndiag, int64_t n, int64_t m,
                                 const void* x, int64_t hl, int64_t nx,
                                 int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 int64_t vec, int64_t col_tile, int64_t copy16,
                                 int64_t vec16, int64_t row_fast,
                                 void* stream) {
  if (bad_plan<double>(m, vec, col_tile, row_fast) || hl < 0 || nx < n + hl)
    return (int)cudaErrorInvalidValue;
  const auto fn = vec == 2 ? launch_staged<double, 2>
                           : launch_staged<double, 1>;
  return fn((const double*)values, (const int*)offsets, (int)ndiag, n, m,
            (const double*)x, hl, nx, xs_i, xs_j, (double*)y, ys_i, ys_j,
            (int)col_tile, (int)copy16, (int)vec16, (int)row_fast,
            (cudaStream_t)stream);
}

extern "C" int gcge_dia_spmm_f32(const void* values, const void* offsets,
                                 int64_t ndiag, int64_t n, int64_t m,
                                 const void* x, int64_t hl, int64_t nx,
                                 int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 int64_t vec, int64_t col_tile, int64_t copy16,
                                 int64_t vec16, int64_t row_fast,
                                 void* stream) {
  if (bad_plan<float>(m, vec, col_tile, row_fast) || hl < 0 || nx < n + hl)
    return (int)cudaErrorInvalidValue;
  const auto fn = vec == 4   ? launch_staged<float, 4>
                  : vec == 2 ? launch_staged<float, 2>
                             : launch_staged<float, 1>;
  return fn((const float*)values, (const int*)offsets, (int)ndiag, n, m,
            (const float*)x, hl, nx, xs_i, xs_j, (float*)y, ys_i, ys_j,
            (int)col_tile, (int)copy16, (int)vec16, (int)row_fast,
            (cudaStream_t)stream);
}
