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
// The wide path (dia_spmm_wide, both types): the narrow design above holds
// one column tile of at most kItems groups, 20 floats or 10 doubles, so an
// operand wider than that (the wide solves' CG operands, m = 40 and 80, and
// kernel 1's operands there) leaves its flat copy for 4-byte copies (f32),
// stages the value rows once a tile and reads a window element from shared
// memory once a term.  On the H100 (80GB HBM3, 700 W; PERF.md) kernel 2
// took 0.18-0.19 ms at (40, n) and (80, n), slower than
// torch.sparse.mm at (80, n), and its window copies held it (left out:
// 0.06 of 0.18 ms).  A block of the wide path holds all columns of its rows,
// up to a slab of kSlab (wider operands, such as the initial
// Rayleigh-Ritz's V[:, :size_x], in slabs of whole 16-byte groups, the
// values staged once a slab):
//   * thread t takes column group g = t % G of the block's G = width / VEC
//     and the ITEMS consecutive rows of row block t / G; a run of k offsets
//     reads each of the ITEMS + k - 1 window rows it needs from shared
//     memory once, into registers, and adds it into the k rows it serves
//     (a thread's rows rt apart, each term read anew, measured 35-60 %
//     slower at every wide operand);
//   * window rows are ld elements apart, each block of ITEMS rows `skew`
//     more, so that the threads of a warp, which span several row blocks,
//     read 16 bytes each from different banks;
//   * the window of a run is copied in 16-byte pieces only, each row's
//     segment from its 16-byte floor (x's rows a multiple of 16 bytes
//     apart: the CG operand at m % 4 == 0, views of V, the Ritz block), a
//     piece's row, column and source stepped without a division or a
//     multiplication; an odd-offset window (`ritz`) keeps its phase `sh` in
//     shared memory and is read one element at a time (VEC 1);
//   * f64 rows an odd number of doubles apart (PAS's contiguous (n, 75)
//     block: rows 600 bytes apart) alternate between two 16-byte phases
//     (TWO): each window row is still copied in 16-byte pieces from its own
//     16-byte floor, so its element c lands at its own phase past the row's
//     start in shared memory, and a thread, reading one element at a time
//     (VEC 1), adds the phase of the row it reads: one of two, alternating
//     row by row, the same for every thread of the block.  8-byte copies
//     for the odd rows would have doubled their copies;
//   * blocks of 128 threads, registers bounded so that 5 or 6 fit an SM
//     (kWideMinBlocks), a ring of two runs (35-38 KB; above 48 KB a block
//     would opt in once, at its first launch, which comes before any
//     capture: the captured stage runs once eagerly first).  256 threads,
//     no register bound, a third ring stage, 16 rows a thread and value
//     rows read 16 bytes at a time each measured slower.
// Each output element sums the same terms in the same order with the same
// fused multiply-adds as on the narrow path: the two paths give the same
// bits.  spmm.dia_plan picks the path and its plan.  What holds it now
// (parts left out on the H100 80GB HBM3 at 700 W, PERF.md): at kernel 1's
// V windows and refresh the multiply-adds with their shared-memory reads
// and the window copies in about equal parts (0.085 and 0.073 ms of 0.115
// left when the other is out); at the odd-offset windows the copies (0.132
// of 0.142 ms), which run faster at some pieces a row than at others (not
// understood; a warp a row measured slower at every operand).
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

// ---- the wide path ------------------------------------------------------

constexpr int kSlab = 80;               // most columns of a wide block
constexpr int kWideThreads = 128;       // most threads of a wide block
constexpr int kWideStages = 2;          // runs in the wide ring
constexpr int kMaxDevices = 64;

// blocks an SM the registers of a wide block allow (__launch_bounds__): 5
// where a thread reads 16 bytes at once, 6 where it reads fewer (8-byte
// reads of an odd-offset window), the fastest of 4-7 on the H100 (PERF.md);
// without the bound the compiler kept 115-179 registers, and 2-3
// blocks fit an SM
template <typename T, int VEC>
constexpr int kWideMinBlocks = VEC * (int)sizeof(T) == 16 ? 5 : 6;

// rows a thread of the wide path holds: 8, twice that where a read is
// narrower than 16 bytes
template <typename T, int VEC>
constexpr int kWideItems = VEC * (int)sizeof(T) < 16 ? 16 : 8;

// log2 of kWideItems
template <typename T, int VEC>
constexpr int kWideItemsLog2 = kWideItems<T, VEC> == 16 ? 4 : 3;

// Where window row a of a wide stage starts: rows ld elements apart, and
// every block of ITEMS rows `skew` elements further on, so that the
// threads of a warp, one row block of ITEMS rows after another, read
// different banks (spmm.DiaWidePlan.skew)
template <int LOG2_ITEMS>
__device__ __forceinline__ int wide_row(int a, int ld, int skew) {
  return a * ld + (a >> LOG2_ITEMS) * skew;
}

// elements of a wide stage: the window, R + kRun - 1 rows of ld and their
// skews, rounded to 16 bytes; then kRun value rows of R
template <typename T>
__host__ __device__ constexpr int wide_window_elems(int R, int ld, int skew,
                                                   int items) {
  return ((R + kRun - 1) * ld + ((R + kRun - 1) / items + 1) * skew +
          kPer16<T> - 1) /
         kPer16<T> * kPer16<T>;
}

template <typename T>
__host__ __device__ constexpr int wide_stage_elems(int R, int ld, int skew,
                                                  int items) {
  return wide_window_elems<T>(R, ld, skew, items) + kRun * R;
}

// The window copy of stage_window_wide where x's rows alternate between two
// 16-byte phases: row a's segment (x row w0 + a, its element c0 at phase
// ph(a), 0 or P / 2 elements past a 16-byte line) is copied from its own
// 16-byte floor to s + wide_row(a), its element c landing at s +
// wide_row(a) + ph(a) + c; a row of the lower phase skips the piece that
// would lie past its segment.  A piece's row, column and row start are
// stepped as in stage_window_wide, the floor and phase taken from the row
// start's address.
template <typename T, int LOG2_ITEMS>
__device__ __forceinline__ void stage_window_two(
    T* s, const T* __restrict__ x, int64_t nx, int64_t xs_i, int64_t w0,
    int rows, int c0, int mt, int ld, int skew) {
  constexpr int P = kPer16<T>;
  const int nt = blockDim.x;
  // pieces of a row at the higher phase, the most a row takes
  const int pieces = (P / 2 + mt + P - 1) / P;
  const int da = nt / pieces, dq = nt - da * pieces;
  int a = threadIdx.x / pieces, q = threadIdx.x - a * pieces;
  const T* row = x + c0 + (w0 + a) * xs_i;
  const int64_t step = da * xs_i;
  const bool all_in = w0 >= 0 && w0 + rows <= nx;
  while (a < rows) {
    const uintptr_t ra = reinterpret_cast<uintptr_t>(row);
    const int ph = (int)(ra & 15) / (int)sizeof(T);
    if (q * P < ph + mt && (all_in || (w0 + a >= 0 && w0 + a < nx)))
      cp_async16(s + wide_row<LOG2_ITEMS>(a, ld, skew) + q * P,
                 reinterpret_cast<const T*>((ra & ~(uintptr_t)15) + 16 * q),
                 16);
    a += da;
    q += dq;
    row += step;
    if (q >= pieces) {
      q -= pieces;
      ++a;
      row += xs_i;
    }
  }
}

// Issue the 16-byte copies of the window of rows [w0, w0 + rows) and
// columns [c0, c0 + mt) of x (nx rows) into `s`: each row's segment starts
// `sh` elements past a 16-byte boundary (the same for every row, x's rows a
// multiple of 16 bytes apart), and is copied from that boundary to s +
// wide_row(a), its element c landing at s + wide_row(a) + sh + c.  A piece
// lies in a 16-byte line that holds an element of the segment, so no copy
// leaves x's pages.  Rows outside [0, nx) are not copied.  TWO: x's rows
// are 8 bytes past a multiple of 16 apart, and each row's own phase takes
// the place of sh (stage_window_two).
template <typename T, int LOG2_ITEMS, bool TWO>
__device__ __forceinline__ void stage_window_wide(
    T* s, const T* __restrict__ x, int64_t nx, int64_t xs_i, int64_t w0,
    int rows, int c0, int mt, int ld, int skew, int sh) {
  constexpr int P = kPer16<T>;
  const int nt = blockDim.x;
  if constexpr (TWO) {
    stage_window_two<T, LOG2_ITEMS>(s, x, nx, xs_i, w0, rows, c0, mt, ld,
                                    skew);
    return;
  }
  // piece q of row a, stepped by nt pieces without a division
  const int pieces = (sh + mt + P - 1) / P;
  const int da = nt / pieces, dq = nt - da * pieces;
  int a = threadIdx.x / pieces, q = threadIdx.x - a * pieces;
  const T* src = x + c0 - sh + (w0 + a) * xs_i + q * P;
  const int64_t step = da * xs_i + dq * P, wrap = xs_i - pieces * P;
  if (w0 >= 0 && w0 + rows <= nx) {       // every row inside x
    while (a < rows) {
      cp_async16(s + wide_row<LOG2_ITEMS>(a, ld, skew) + q * P, src, 16);
      a += da;
      q += dq;
      src += step;
      if (q >= pieces) {
        q -= pieces;
        ++a;
        src += wrap;
      }
    }
    return;
  }
  while (a < rows) {
    const int64_t r = w0 + a;
    if (r >= 0 && r < nx)
      cp_async16(s + wide_row<LOG2_ITEMS>(a, ld, skew) + q * P, src, 16);
    a += da;
    q += dq;
    src += step;
    if (q >= pieces) {
      q -= pieces;
      ++a;
      src += wrap;
    }
  }
}

// Issue the copies of values[d0 + e, i0 : i0 + R) for e < k into `s`, row e
// at s + e R (R a multiple of 16 bytes' worth of elements); vec16 as in
// stage_values.
template <typename T>
__device__ __forceinline__ void stage_values_wide(
    T* s, const T* __restrict__ values, int64_t n, int d0, int k, int64_t i0,
    int R, int vec16) {
  constexpr int P = kPer16<T>;
  const int nt = blockDim.x;
  if (vec16) {
    const int per = R / P;
    for (int c = threadIdx.x; c < k * per; c += nt) {
      const int e = c / per;
      const int64_t i = i0 + P * (c - e * per);
      if (i < n)
        cp_async16(s + e * R + (i - i0), values + (int64_t)(d0 + e) * n + i,
                   16);
    }
    return;
  }
  for (int c = threadIdx.x; c < k * R; c += nt) {
    const int e = c / R;
    const int64_t i = i0 + (c - e * R);
    if (i < n) cp_async_elem<T>(s + c, values + (int64_t)(d0 + e) * n + i);
  }
}

// VEC elements of a window row from shared memory
template <int VEC>
__device__ __forceinline__ Vec<float, VEC> load_vec(const float* p) {
  Vec<float, VEC> v;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v.v[0] = t.x, v.v[1] = t.y, v.v[2] = t.z, v.v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v.v[0] = t.x, v.v[1] = t.y;
  } else {
    v.v[0] = p[0];
  }
  return v;
}

template <int VEC>
__device__ __forceinline__ Vec<double, VEC> load_vec(const double* p) {
  Vec<double, VEC> v;
  if constexpr (VEC == 2) {
    const double2 t = *reinterpret_cast<const double2*>(p);
    v.v[0] = t.x, v.v[1] = t.y;
  } else {
    v.v[0] = p[0];
  }
  return v;
}

template <typename T, int VEC>
__device__ __forceinline__ void fma_reg(Vec<T, VEC>& acc, T a,
                                        const Vec<T, VEC>& x) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    if constexpr (sizeof(T) == 4)
      acc.v[e] = fmaf(a, x.v[e], acc.v[e]);
    else
      acc.v[e] = fma(a, x.v[e], acc.v[e]);
  }
}

// Block (blockIdx.x, blockIdx.y) takes rows [R bx, R bx + R) and the slab of
// columns [slab by, slab by + slab) (the last one may be narrower).  Thread
// t takes column group g = t % G and the ITEMS rows b ITEMS + r of row
// block b = t / G.  A run of k offsets reads its window rows b ITEMS + w,
// w < ITEMS + k - 1, once each, and adds each into the rows it serves (row
// r takes term e from window row r + e): every row's terms still come in
// the order of the offsets.  TWO: x's rows alternate between two 16-byte
// phases (stage_window_two); a window row is read at its own phase.
template <typename T, int VEC, bool TWO>
__global__ void __launch_bounds__(kWideThreads, kWideMinBlocks<T, VEC>)
    dia_spmm_wide(const T* __restrict__ values,
                  const int* __restrict__ offsets, int ndiag, int64_t n,
                  int64_t m, const T* __restrict__ x, int64_t hl, int64_t nx,
                  int64_t xs_i, T* __restrict__ y, int64_t ys_i,
                  int64_t ys_j, int slab, int rt, int ld, int skew, int sh,
                  int vec16) {
  constexpr int ITEMS = kWideItems<T, VEC>;
  constexpr int L2I = kWideItemsLog2<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int R = rt * ITEMS;
  const int slot = wide_stage_elems<T>(R, ld, skew, ITEMS);
  const int win = wide_window_elems<T>(R, ld, skew, ITEMS);
  const int64_t i0 = (int64_t)blockIdx.x * R;
  const int c0 = blockIdx.y * slab;
  const int mt = (int)(m - c0 < slab ? m - c0 : slab);
  const int G = mt / VEC;
  const bool active = (int)threadIdx.x < G * rt;
  const int b = threadIdx.x / G;
  const int g = threadIdx.x - b * G;
  const int rows = (int)(n - i0 < R ? n - i0 : R);
  const int a0 = b * ITEMS;             // the thread's first row

  Vec<T, VEC> acc[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[j].v[e] = T(0);

  int d_issue = 0;
  auto issue = [&](int stage) {
    if (d_issue < ndiag) {
      const int k = run_length(offsets, ndiag, d_issue);
      T* s = smem + stage * slot;
      stage_window_wide<T, L2I, TWO>(s, x, nx, xs_i,
                                hl + i0 + __ldg(offsets + d_issue), R + k - 1,
                                c0, mt, ld, skew, sh);
      stage_values_wide<T>(s + win, values, n, d_issue, k, i0, R, vec16);
      d_issue += k;
    }
    cp_commit();
  };
#pragma unroll
  for (int st = 0; st < kWideStages - 1; ++st) issue(st);
  int stage = 0;
  for (int d0 = 0; d0 < ndiag;) {
    issue(stage == 0 ? kWideStages - 1 : stage - 1);
    cp_wait<kWideStages - 1>();
    __syncthreads();
    const int k = run_length(offsets, ndiag, d0);
    const int64_t w0 = hl + i0 + __ldg(offsets + d0);
    const T* s = smem + stage * slot + (TWO ? 0 : sh) + g * VEC;
    const T* sv = smem + stage * slot + win + a0;
    // TWO: the phase of the thread's first window row (x row w0 + a0), in
    // elements; window row a0 + w is at phase ph(w), the other phase at odd w
    constexpr int P = kPer16<T>;
    const int pb = TWO ? (int)((sh + (w0 + a0) * xs_i + c0) & (P - 1)) : 0;
    auto ph = [&](int w) { return TWO ? (pb + w * (P / 2)) & (P - 1) : 0; };
    // inside x, every row's every term is in range: no checks
    const bool inside = rows == R && w0 >= 0 && w0 + R + k - 1 <= nx;
    if (!active) {
    } else if (inside) {
#pragma unroll
      for (int w = 0; w < ITEMS + kRun - 1; ++w) {
        if (w < ITEMS + k - 1) {
          const Vec<T, VEC> xv =
              load_vec<VEC>(s + wide_row<L2I>(a0 + w, ld, skew) + ph(w));
#pragma unroll
          for (int e = 0; e < kRun; ++e)      // row w - e takes term e
            if (w - e >= 0 && w - e < ITEMS && e < k)
              fma_reg<T, VEC>(acc[w - e], sv[e * R + w - e], xv);
        }
      }
    } else {
#pragma unroll
      for (int w = 0; w < ITEMS + kRun - 1; ++w) {
        const int64_t c = w0 + a0 + w;   // the row of x that w holds
        if (w < ITEMS + k - 1 && c >= 0 && c < nx) {
          const Vec<T, VEC> xv =
              load_vec<VEC>(s + wide_row<L2I>(a0 + w, ld, skew) + ph(w));
#pragma unroll
          for (int e = 0; e < kRun; ++e)
            if (w - e >= 0 && w - e < ITEMS && e < k && a0 + w - e < rows)
              fma_reg<T, VEC>(acc[w - e], sv[e * R + w - e], xv);
        }
      }
    }
    __syncthreads();     // this stage is refilled on the next step
    d0 += k;
    stage = stage == kWideStages - 1 ? 0 : stage + 1;
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if (a0 + j < rows)
      store_vec<VEC>(y + (i0 + a0 + j) * ys_i +
                         (int64_t)(c0 + g * VEC) * ys_j,
                     acc[j]);
}

// cudaFuncAttributeMaxDynamicSharedMemorySize, set once per instantiation
// and device, at its first launch with a ring above 48 KB
template <typename Kernel>
int allow_smem(Kernel kernel, bool (&done)[kMaxDevices], size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < kMaxDevices && done[dev]) return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
  if (err == 0 && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T, int VEC, bool TWO>
int launch_wide(const T* values, const int* offsets, int ndiag, int64_t n,
                int64_t m, const T* x, int64_t hl, int64_t nx, int64_t xs_i,
                T* y, int64_t ys_i, int64_t ys_j, int slab, int rt, int ld,
                int skew, int sh, int vec16, cudaStream_t stream) {
  constexpr int ITEMS = kWideItems<T, VEC>;
  constexpr int P = kPer16<T>;
  const int R = rt * ITEMS;
  const int G = slab / VEC;
  const int64_t row_blocks = (n + R - 1) / R;
  const int64_t nslabs = (m + slab - 1) / slab;
  const int threads = (G * rt + 31) / 32 * 32;
  // the slabs are whole 16-byte groups (or one slab of all m), a window
  // row holds its segment and phase on 16 bytes (TWO: at either phase, the
  // higher sh | P / 2), R rows of values are whole pieces
  const int ph_max = TWO ? (sh | (P / 2)) : sh;
  if (slab <= 0 || slab > kSlab || slab % VEC != 0 || m % VEC != 0 ||
      (nslabs > 1 && slab % P != 0) || rt <= 0 || threads > kWideThreads ||
      sh < 0 || sh >= P || sh % VEC != 0 || skew < 0 || skew % P != 0 ||
      ld < ph_max + (slab < m ? slab : m) || ld % P != 0 ||
      row_blocks > 0x7fffffff || nslabs > 0xffff)
    return (int)cudaErrorInvalidValue;
  // the 16-byte copies' source lines (TWO: x's rows 8 bytes past a multiple
  // of 16 apart, read one element at a time), and VEC elements of y at once
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  if ((xa - sh * sizeof(T)) % 16 != 0 ||
      xs_i * sizeof(T) % 16 != (TWO ? 8u : 0u) || (TWO && VEC != 1) ||
      (VEC > 1 && (ys_j != 1 || ys_i % VEC != 0 ||
                   reinterpret_cast<uintptr_t>(y) % (VEC * sizeof(T)) != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      kWideStages * sizeof(T) * wide_stage_elems<T>(R, ld, skew, ITEMS);
  static bool done[kMaxDevices];
  int err = allow_smem(dia_spmm_wide<T, VEC, TWO>, done, smem);
  if (err != 0) return err;
  dia_spmm_wide<T, VEC, TWO>
      <<<dim3((unsigned)row_blocks, (unsigned)nslabs), threads, smem,
         stream>>>(values, offsets, ndiag, n, m, x, hl, nx, xs_i, y, ys_i,
                   ys_j, slab, rt, ld, skew, sh, vec16);
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

// The wide path of kernel 1 (f64) and kernel 2 (f32): x's and y's columns
// adjacent (unit column stride); vec: 2 or 1 (f64), 4, 2 or 1 (f32); slab:
// columns a block holds; rt: rows a pass of the block's threads covers
// (R = rt kWideItems rows a block); ld: elements a window row takes in
// shared memory; skew: elements between blocks of kWideItems window rows
// beyond ld (see wide_row); sh: the phase of x's row segments (f64 rows an
// odd number of doubles apart: the phase of row 0's, the rows alternating
// between two phases, vec 1); vec16: see stage_values.  The launch plan is
// spmm.dia_plan's (DiaWidePlan).
extern "C" int gcge_dia_spmm_wide_f64(const void* values, const void* offsets,
                                      int64_t ndiag, int64_t n, int64_t m,
                                      const void* x, int64_t hl, int64_t nx,
                                      int64_t xs_i, void* y, int64_t ys_i,
                                      int64_t ys_j, int64_t vec, int64_t slab,
                                      int64_t rt, int64_t ld, int64_t skew,
                                      int64_t sh, int64_t vec16,
                                      void* stream) {
  if ((vec != 1 && vec != 2) || (xs_i % 2 && vec != 1) || hl < 0 ||
      nx < n + hl)
    return (int)cudaErrorInvalidValue;
  const auto fn = xs_i % 2     ? launch_wide<double, 1, true>
                  : vec == 2     ? launch_wide<double, 2, false>
                                 : launch_wide<double, 1, false>;
  return fn((const double*)values, (const int*)offsets, (int)ndiag, n, m,
            (const double*)x, hl, nx, xs_i, (double*)y, ys_i, ys_j, (int)slab,
            (int)rt, (int)ld, (int)skew, (int)sh, (int)vec16,
            (cudaStream_t)stream);
}

extern "C" int gcge_dia_spmm_wide_f32(const void* values, const void* offsets,
                                      int64_t ndiag, int64_t n, int64_t m,
                                      const void* x, int64_t hl, int64_t nx,
                                      int64_t xs_i, void* y, int64_t ys_i,
                                      int64_t ys_j, int64_t vec, int64_t slab,
                                      int64_t rt, int64_t ld, int64_t skew,
                                      int64_t sh, int64_t vec16,
                                      void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || hl < 0 || nx < n + hl)
    return (int)cudaErrorInvalidValue;
  const auto fn = vec == 4   ? launch_wide<float, 4, false>
                  : vec == 2 ? launch_wide<float, 2, false>
                             : launch_wide<float, 1, false>;
  return fn((const float*)values, (const int*)offsets, (int)ndiag, n, m,
            (const float*)x, hl, nx, xs_i, (float*)y, ys_i, ys_j, (int)slab,
            (int)rt, (int)ld, (int)skew, (int)sh, (int)vec16,
            (cudaStream_t)stream);
}
