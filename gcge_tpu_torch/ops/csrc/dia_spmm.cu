// DIA sparse matrix times multivector on Hopper (kernels 1 and 2 of the port).
//
//   y[i, j] = sum_d values[d, i] * x[i + off_d, j]     (0 <= i + off_d < n)
//
// x and y are logical (n, m) matrices given by 2-D strides, so the same entry
// points serve the row-major (n, m) layout of DiaOperator.matvec and the
// transposed (m, n) layout of matvec_t, views included, without a copy.  In
// both kernels the sum runs in T, in the order of the offsets, as both TPU
// paths do, one fused multiply-add a term, with no atomics: two launches on
// the same inputs give the same bits.
//
// Kernel 1, dia_spmm<double>: replaces gcge_tpu/ops/spmm_pallas.py:
//   _dia_spmm_t_df64 (f64 quality from f32 hi/lo planes, because the TPU has
//   no f64).  One thread computes one output element; the index map puts the
//   contiguous dimension of y fastest, so stores coalesce and the value row
//   values[d, i] is shared by neighbouring threads.  At the headline shape
//   (27 diagonals, n = 157,464, m = 10) one call moves 34 MB of values and
//   12.6 MB each of x and y for 85 MFLOP: bound by device memory.
//
// Kernel 2, dia_spmm_f32_staged: replaces spmm_pallas.py:_dia_spmm_t (the f32
//   kernel of the mixed-precision inner CG, which stages three lane tiles of
//   x in VMEM and slices a shifted window per diagonal).
//   Bound: at the headline shape one call must move 17.0 MB of values and
//   6.3 MB each of x and y (8.8 us at 3.35 TB/s) for 85 MFLOP.
//   Design, for the CG's operand: (m, n) in shape, (n, m) in memory, so a row
//   of the logical x, one m-float record, is contiguous.
//   * A block owns kRows consecutive rows and a tile of up to kItems VEC
//     columns (all m = 10 of the CG); thread t holds the items t, t + kRows, ... of
//     the tile's (row, column group) pairs, column group fastest, VEC floats
//     a group, and keeps their sums in registers until y is written once.
//   * Offsets that follow each other (o, o + 1, ..., up to kRun of them; the
//     27-point stencil has nine runs of three) form a run.  The rows
//     [i0 + o, i0 + o + kRows + k - 1) of x serve a whole run of k.  A stage
//     holds that window and the run's k value rows values[d, i0:i0+kRows]:
//     the values are read once a row, x once a run instead of once a
//     diagonal.  Both are copied into shared memory with cp.async, 16-byte
//     copies of contiguous ranges (the window is one range when x's rows are
//     contiguous and adjacent; 4-byte copies otherwise).
//   * The stages form a ring of kStages (two: deeper rings measured no
//     faster on the H100, and take shared memory from other blocks): the
//     next run's copies are in flight while a run's multiply-adds read
//     shared memory, and no load waits inside the multiply-adds.  The loop
//     over a run's terms checks no bounds where every row of the block and
//     every term lies inside the matrix, all but the blocks at its ends.
//   * Rows outside [0, n) are never read and their terms are skipped, as in
//     kernel 1.
//
// Plain C interface (built with nvcc, loaded with ctypes): each entry point
// returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void dia_spmm_kernel(const T* __restrict__ values,
                                const int* __restrict__ offsets, int ndiag,
                                int64_t n, int64_t m,
                                const T* __restrict__ x, int64_t xs_i,
                                int64_t xs_j, T* __restrict__ y, int64_t ys_i,
                                int64_t ys_j, int j_fast) {
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
  T acc = T(0);
  for (int d = 0; d < ndiag; ++d) {
    const int64_t c = i + (int64_t)__ldg(offsets + d);
    if (c >= 0 && c < n) acc += values[(int64_t)d * n + i] * x[c * xs_i + j * xs_j];
  }
  y[i * ys_i + j * ys_j] = acc;
}

// ---- kernel 2 ---------------------------------------------------------------

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
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// floats a window takes: its rows of the column tile and 8 floats of
// alignment slack, rounded to 16 bytes; a stage adds kRun value rows
__host__ __device__ constexpr int window_floats(int col_tile) {
  return (kWin * col_tile + 8 + 3) / 4 * 4;
}

__host__ __device__ constexpr int stage_floats(int col_tile) {
  return window_floats(col_tile) + kRun * kRows;
}

// the widest column tile (kItems groups of 4) fits the 48 KB a block may use
// without opting in to more
static_assert(kStages * sizeof(float) * stage_floats(4 * kItems) <= 48 * 1024,
              "the ring does not fit 48 KB of shared memory");

// the length of the run of offsets that starts at d0
__device__ __forceinline__ int run_length(const int* __restrict__ offsets,
                                          int ndiag, int d0) {
  const int o = __ldg(offsets + d0);
  int k = 1;
  while (k < kRun && d0 + k < ndiag && __ldg(offsets + d0 + k) == o + k) ++k;
  return k;
}

// Issue the copies of the window of rows [w0, w0 + rows) and columns
// [c0, c0 + mt) into `s`.  flat: x's rows are contiguous and adjacent
// (xs_j = 1, xs_i = m = mt) and x starts on 16 bytes, so the window is one
// range of floats, copied in 16-byte pieces from its 16-byte-aligned start,
// and its first element lands at s + window_shift(w0, m).
__device__ __forceinline__ int window_shift(int64_t w0, int64_t m) {
  return (int)((w0 * m) & 3);
}

__device__ __forceinline__ void stage_window(float* s, const float* x,
                                           int64_t n, int64_t m, int64_t xs_i,
                                           int64_t xs_j, int64_t w0, int rows,
                                           int c0, int mt, int flat) {
  if (flat) {
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

// Issue the copies of values[d0 + e, i0 : i0 + kRows) for e < k into `s`,
// row e at s + e * kRows; columns past n are not read.  vec16: n is a
// multiple of 4 and values starts on 16 bytes.
__device__ __forceinline__ void stage_values(float* s,
                                             const float* __restrict__ values,
                                             int64_t n, int d0, int k,
                                             int64_t i0, int vec16) {
  if (vec16) {
    for (int c = threadIdx.x; c < k * (kRows / 4); c += kRows) {
      const int e = c / (kRows / 4);
      const int64_t i = i0 + 4 * (c - e * (kRows / 4));
      if (i < n)
        cp_async16(s + e * kRows + (i - i0),
                   values + (int64_t)(d0 + e) * n + i, 16);
    }
    return;
  }
  for (int c = threadIdx.x; c < k * kRows; c += kRows) {
    const int e = c / kRows;
    const int64_t i = i0 + (c - e * kRows);
    if (i < n) cp_async4(s + c, values + (int64_t)(d0 + e) * n + i);
  }
}

// VEC floats of a window or of y, and their fused multiply-adds
template <int VEC>
struct Vec {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ void fma_vec(Vec<VEC>& acc, float a,
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
__device__ __forceinline__ void store_vec(float* p, const Vec<VEC>& acc) {
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
__global__ void __launch_bounds__(kRows)
    dia_spmm_f32_staged(const float* __restrict__ values,
                        const int* __restrict__ offsets, int ndiag, int64_t n,
                        int64_t m, const float* __restrict__ x, int64_t xs_i,
                        int64_t xs_j, float* __restrict__ y, int64_t ys_i,
                        int64_t ys_j, int col_tile, int flat, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const int slot = stage_floats(col_tile);
  const int win = window_floats(col_tile);
  const int64_t i0 = (int64_t)blockIdx.x * kRows;
  const int c0 = blockIdx.y * col_tile;
  const int mt = (int)(m - c0 < col_tile ? m - c0 : col_tile);
  const int groups = mt / VEC;

  // the thread's items: row a_k[k] of the block; xo_k[k], the offset of its
  // column group in a window row
  int a_k[kItems], xo_k[kItems];
  Vec<VEC> acc[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int item = threadIdx.x + k * kRows;
    a_k[k] = item / groups;
    xo_k[k] = a_k[k] * mt + (item - a_k[k] * groups) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[k].v[e] = 0.0f;
  }
  const int rows = (int)(n - i0 < kRows ? n - i0 : kRows);

  // the ring: run r lives in stage r % kStages; every step commits one copy
  // group (empty once the runs are all issued)
  int d_issue = 0;
  auto issue = [&](int stage) {
    if (d_issue < ndiag) {
      const int k = run_length(offsets, ndiag, d_issue);
      float* s = smem + stage * slot;
      stage_window(s, x, n, m, xs_i, xs_j, i0 + __ldg(offsets + d_issue),
                   kRows + k - 1, c0, mt, flat);
      stage_values(s + win, values, n, d_issue, k, i0, vec16);
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
    const float* s = smem + stage * slot +
                     (flat ? window_shift(i0 + o, m) : 0);
    const float* sv = smem + stage * slot + win;
    // inside the matrix, every row's every term is in range: no checks
    const bool inside = rows == kRows && i0 + o >= 0 &&
                        i0 + o + kRows + k - 1 <= n;
    if (inside) {
      for (int e = 0; e < k; ++e) {
#pragma unroll
        for (int kk = 0; kk < kItems; ++kk)
          if (kk < groups)
            fma_vec<VEC>(acc[kk], sv[e * kRows + a_k[kk]],
                         s + e * mt + xo_k[kk]);
      }
    } else {
      for (int e = 0; e < k; ++e) {
#pragma unroll
        for (int kk = 0; kk < kItems; ++kk) {
          const int64_t c = i0 + a_k[kk] + o + e;
          if (kk < groups && a_k[kk] < rows && c >= 0 && c < n)
            fma_vec<VEC>(acc[kk], sv[e * kRows + a_k[kk]],
                         s + e * mt + xo_k[kk]);
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
                         (int64_t)(c0 + xo_k[kk] - a_k[kk] * mt) * ys_j,
                     acc[kk]);
}

template <typename T>
int launch(const T* values, const int* offsets, int64_t ndiag, int64_t n,
           int64_t m, const T* x, int64_t xs_i, int64_t xs_j, T* y,
           int64_t ys_i, int64_t ys_j, void* stream) {
  const int threads = 256;
  const int64_t total = n * m;
  const int64_t blocks = (total + threads - 1) / threads;
  const int j_fast = ys_j <= ys_i ? 1 : 0;
  dia_spmm_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      values, offsets, (int)ndiag, n, m, x, xs_i, xs_j, y, ys_i, ys_j, j_fast);
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_staged(const float* values, const int* offsets, int ndiag,
                  int64_t n, int64_t m, const float* x, int64_t xs_i,
                  int64_t xs_j, float* y, int64_t ys_i, int64_t ys_j,
                  int col_tile, int flat, int vec16, cudaStream_t stream) {
  const dim3 grid((unsigned)((n + kRows - 1) / kRows),
                  (unsigned)((m + col_tile - 1) / col_tile));
  const size_t smem = kStages * sizeof(float) * stage_floats(col_tile);
  dia_spmm_f32_staged<VEC><<<grid, kRows, smem, stream>>>(
      values, offsets, ndiag, n, m, x, xs_i, xs_j, y, ys_i, ys_j, col_tile,
      flat, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gcge_dia_spmm_f64(const void* values, const void* offsets,
                                 int64_t ndiag, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 void* stream) {
  return launch<double>((const double*)values, (const int*)offsets, ndiag, n,
                        m, (const double*)x, xs_i, xs_j, (double*)y, ys_i,
                        ys_j, stream);
}

// vec: floats a thread reads from a window and writes to y at once (4, 2 or
// 1); col_tile: columns a block holds, at most kItems vec; flat: see
// stage_window; vec16: see stage_values.  The launch plan is spmm.dia_plan's.
extern "C" int gcge_dia_spmm_f32(const void* values, const void* offsets,
                                 int64_t ndiag, int64_t n, int64_t m,
                                 const void* x, int64_t xs_i, int64_t xs_j,
                                 void* y, int64_t ys_i, int64_t ys_j,
                                 int64_t vec, int64_t col_tile, int64_t flat,
                                 int64_t vec16, void* stream) {
  if (col_tile <= 0 || col_tile > kItems * vec || col_tile % vec != 0 ||
      m % vec != 0)
    return (int)cudaErrorInvalidValue;
  const auto fn = vec == 4   ? launch_staged<4>
                  : vec == 2 ? launch_staged<2>
                             : launch_staged<1>;
  return fn((const float*)values, (const int*)offsets, (int)ndiag, n, m,
            (const float*)x, xs_i, xs_j, (float*)y, ys_i, ys_j, (int)col_tile,
            (int)flat, (int)vec16, (cudaStream_t)stream);
}
